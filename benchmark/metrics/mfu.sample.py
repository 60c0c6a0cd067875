"""mfu.sample: share (%) of the configuration's peak of the model
operations of the window's requests (T + 1 denoiser forwards at each
sample's real atom count and the bond predictor; ``flops.request_flops``)
over the window's seconds."""

from benchmark import flops, layers


def read(run):
    return layers.mfu(run, flops.request_flops)
