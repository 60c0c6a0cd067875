"""edge_bwd_roofline.train: share (%) of their roofline of the float32
backward edge calls over the traced train steps: the backward kernel and
its [dW1 | db1] product, the library GEMM launched after it, against the
three products of the backward's bound."""

from benchmark import layers


def read(run):
    return layers.edge_roofline(run, ("bwd_f32",), with_product=True)
