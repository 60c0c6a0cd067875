"""edge_wide_bwd_roofline.drugs_train: share (%) of their roofline of the
traced train steps' float32 backward calls on the wide kernel
(``edge_mlp_bwd_f32_wide_kernel``) with their [dW1 | db1] product, the
library GEMM launched after each, against the backward's bound as
``edge_bwd_roofline.train`` counts it (``drugs_train.f32_roofline``)."""

from benchmark import drugs_train


def read(run):
    return drugs_train.f32_roofline(run, backward=True, wide_only=True)
