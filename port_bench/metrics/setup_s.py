"""Seconds from the start of the process to the first measured request:
imports, CUDA start, kernel builds where none are cached, the weights,
the traffic's own set-up (encode, staging) and the warm-up."""


def read(run):
    return run["setup_s"]
