"""device_idle.train: share (%) of the traced train steps' window in which
no operation ran on the device."""

from benchmark import layers


def read(run):
    return layers.idle(run)
