"""Seconds from the harness's start to the first timed step: the CUDA
context, the kernels' libraries, the parameters made from the seed, and the
first steps."""


def read(record):
    return record["setup_s"]
