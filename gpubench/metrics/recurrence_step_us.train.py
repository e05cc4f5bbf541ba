"""Device microseconds a serial recurrence step: the device time of the
kernels that kernels/recurrence.*.json names over the traced window's serial
steps (``recurrence_steps``: T of every forward and backward recurrence
launch); None where the window's context carries no such count."""

from gpubench.readers import layer_seconds


def read(ctx):
    steps = getattr(ctx, "recurrence_steps", None)
    if not steps:
        return None
    return 1e6 * layer_seconds(ctx, "recurrence") / steps
