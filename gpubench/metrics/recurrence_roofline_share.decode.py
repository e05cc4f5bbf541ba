"""Least time of the traced window's recurrence work over the device time
of the kernels that kernels/recurrence.*.json names, percent."""

from gpubench.readers import roofline_share


def read(ctx):
    return roofline_share(ctx, "recurrence", ctx.recurrence_least_s,
                          "recurrence_roofline_share.decode")
