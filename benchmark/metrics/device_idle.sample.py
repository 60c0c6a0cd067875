"""device_idle.sample: share (%) of the traced requests' window in which
no operation ran on the device."""

from benchmark import layers


def read(run):
    return layers.idle(run)
