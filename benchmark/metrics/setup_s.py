"""From the process's start to the first timed operation: the CUDA context,
the weights made on the device, the kernels loaded (built on a checkout's
first run), the pipeline and the warm-up of the cell's shapes."""


def read(rec, ctx):
    return ctx.setup_s
