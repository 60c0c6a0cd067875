"""edge_fwd_roofline.drugs_train: share (%) of their roofline of every
float32 forward edge launch of the traced train steps, the N <= 128
kernel's and the wide one's, each at its step's (molecules, padded nodes)
(``drugs_train.f32_roofline``)."""

from benchmark import drugs_train


def read(run):
    return drugs_train.f32_roofline(run, backward=False, wide_only=False)
