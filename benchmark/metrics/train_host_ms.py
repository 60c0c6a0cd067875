"""train_host_ms: mean over the traced train steps of the host ms spent
outside the step's device body: the wait for the prefetched batch
(``mlcg.data.wait``), its copies to the device (``mlcg.train.batch``),
the draws (``mlcg.train.draws``, with the seed's sync) and the EMA update
(``mlcg.train.ema``)."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    return spans.mean_span_ms(run.trace, spans.TRAIN_HOST)
