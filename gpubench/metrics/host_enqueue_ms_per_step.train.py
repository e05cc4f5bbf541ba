"""Host milliseconds a step spent in the epoch runner's call, up to its
return: the enqueue of the step graphs' replays."""

from gpubench.readers import per_step_ms


def read(ctx):
    return per_step_ms(ctx.spans.get("enqueue", 0.0), ctx)
