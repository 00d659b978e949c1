"""setup_s: from the process's start to the window's start: imports, the
kernels' build or load, weights, scenes, the streams' warm-up."""


def read(run):
    return run.setup_s
