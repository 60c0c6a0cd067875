"""host_chem_ms: mean host ms of a request's chemistry
(``last_metrics`` ``featurize_s`` + ``standardize_s``: connectivity,
canonical order, sanitisation, the force field), over every request of
the window."""

from benchmark import layers


def read(run):
    return layers.mean_stage_ms(run, "featurize", "standardize")
