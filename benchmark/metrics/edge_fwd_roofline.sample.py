"""edge_fwd_roofline.sample: share (%) of their roofline of the forward
edge kernels (bf16 or float32, gcl and coord) over every launch in the
traced requests, each launch's bound at its request's (samples, node
bucket); the card's power limit is on the run's card line."""

from benchmark import layers


def read(run):
    return layers.edge_roofline(run, ("bf16", "f32"))
