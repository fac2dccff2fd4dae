"""From the process's start to the first timed call: imports, the CUDA
context, the kernels (built on a checkout's first run, loaded after),
the burst pool and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
