"""edge_bwd_roofline.drugs_train: share (%) of their roofline of every
float32 backward edge call of the traced train steps (both kernels, each
with its [dW1 | db1] product), each at its step's (molecules, padded
nodes) (``drugs_train.f32_roofline``)."""

from benchmark import drugs_train


def read(run):
    return drugs_train.f32_roofline(run, backward=True, wide_only=False)
