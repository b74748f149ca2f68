"""Codeword bytes (n blocks of data and parity) of every call in the
window, over the window's seconds, in GB/s."""


def read(run):
    return run.codeword_GBps()
