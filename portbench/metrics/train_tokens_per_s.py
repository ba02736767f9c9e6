"""Tokens of every step completed in the window over the window's
seconds; checkpoint calls and restores are inside the window."""


def read(run: dict):
    return run["tokens"] / run["window_s"]
