"""sample_wait_ms: mean over the traced requests of the host ms of the
samples' copy to the host (``mlcg.sample.to_host``): the host blocked
until the trajectory's replay ends, then the copy."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    return spans.mean_span_ms(run.trace, ["mlcg.sample.to_host"])
