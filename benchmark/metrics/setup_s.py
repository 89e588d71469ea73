"""Set-up: from the process's start to the window's opening: imports, kernel
builds (cached in the checkout after the first run), weights, graph
captures, warm-up."""


def read(run):
    return run.setup_s
