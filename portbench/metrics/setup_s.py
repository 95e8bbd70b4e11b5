"""Process start to the window's first due call: imports, the CUDA
context, the kernel library, the weights made on the card, the warm-up
and any prefix the traffic needs warm."""


def read(run):
    return run.setup_s
