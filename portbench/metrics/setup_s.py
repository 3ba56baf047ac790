"""Seconds from the start of the process to the window's start."""


def read(run):
    return run["setup_s"]
