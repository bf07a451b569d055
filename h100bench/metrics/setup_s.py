"""Set-up seconds: process start to the window's start (imports, the CUDA
context, the kernels' build, seeded data and weights, the first steps or
warm-up requests), on the host clock."""


def read(record):
    return record["setup_s"]
