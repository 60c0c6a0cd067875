"""idle_prelude.sample: share (%) of the traced requests' window in which
the device was idle while the host was in the sampler's prelude
(``mlcg.sample.prelude`` and the spans inside it), each stretch of idle
time going to the innermost program span open over it."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    return spans.idle_share(run.trace, ["mlcg.sample.prelude"])
