"""sample_prelude_ms: mean over the traced requests of the host ms a
request spends in the sampler's prelude (its ``mlcg.sample.prelude``
spans, summed: the sizes and masks, the scalar table, the noise draws,
the weights token and the graph's lookup), before the trajectory runs."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    return spans.mean_span_ms(run.trace, ["mlcg.sample.prelude"])
