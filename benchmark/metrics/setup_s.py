"""setup_s: seconds from the process's start to the window's start:
imports, the device's start, the kernels' load (or build), the weights,
and the set-up units that capture every graph the window replays."""


def read(run):
    return run.setup_s
