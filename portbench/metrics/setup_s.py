"""Seconds from the start of the run to the start of the window: imports,
the kernels' load (and their build in a checkout's first run), weights,
the feed, the first steps and one checkpoint of the cell's kind."""


def read(run: dict):
    return run["setup_s"]
