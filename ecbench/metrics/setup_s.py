"""Set-up: process start to the first timed call (imports, the kernel
library's load or build, inputs made from the seed, warm-up)."""


def read(run):
    return run.setup_s
