"""Seconds from the process's start to the window's first due time:
imports, the kernels' build or load, the models, the weights and inputs
made from the seed, the warm-up (host clock)."""


def read(run):
    return run.setup_s
