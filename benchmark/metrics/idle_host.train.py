"""idle_host.train: share (%) of the traced train steps' window in which
the device was idle while the host was in the step's host work (the
batch's wait and copies, the draws, the EMA update: the spans of
``train_host_ms`` and those inside them), each stretch of idle time going
to the innermost program span open over it."""

from benchmark import spans


def read(run):
    if run.trace is None:
        return None
    return spans.idle_share(run.trace, spans.TRAIN_HOST)
