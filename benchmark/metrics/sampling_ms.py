"""sampling_ms: mean host ms of a request's sampler stage
(``last_metrics["edm_sampling_s"]``: the sampler's graph replay, its
draws and table, and the copy of the samples to the host), over every
request of the window."""

from benchmark import layers


def read(run):
    return layers.mean_stage_ms(run, "edm_sampling")
