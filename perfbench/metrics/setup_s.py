"""From the process's start to the first timed call: imports, the kernels
built or loaded, the pool made and handed to the port, the warm-up."""


def read(ctx):
    return ctx["setup_s"]
