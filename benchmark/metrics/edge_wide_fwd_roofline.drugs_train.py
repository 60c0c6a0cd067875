"""edge_wide_fwd_roofline.drugs_train: share (%) of their roofline of the
traced train steps' float32 forward launches on the wide kernel
(``edge_mlp_f32_wide_kernel``: the steps padded past 128 nodes, the
forward and its recompute under rematerialisation), each reckoned at its
step's (molecules, padded nodes) by ``flops.edge_pass_bound``
(``drugs_train.f32_roofline``); the card's power limit is on the run's
card line."""

from benchmark import drugs_train


def read(run):
    return drugs_train.f32_roofline(run, backward=False, wide_only=True)
