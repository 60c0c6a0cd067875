"""edge_fwd_roofline.train: share (%) of their roofline of the float32
forward edge kernels over every launch in the traced train steps (the
forward and, under rematerialisation, its recompute), at the batch's
(molecules, padded nodes)."""

from benchmark import layers


def read(run):
    return layers.edge_roofline(run, ("f32",))
