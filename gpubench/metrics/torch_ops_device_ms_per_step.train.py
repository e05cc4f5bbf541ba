"""Device milliseconds a step of the kernels that no kernels/*.json table
names: PyTorch's, cuBLAS's and cuDNN's around the port's own."""

from gpubench.readers import per_step_ms, unnamed_seconds


def read(ctx):
    return per_step_ms(unnamed_seconds(ctx), ctx)
