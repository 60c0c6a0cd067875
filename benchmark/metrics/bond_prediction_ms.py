"""bond_prediction_ms: mean host ms of a request's bond-predictor stage
(``last_metrics["bond_prediction_s"]``), over every request of the
window."""

from benchmark import layers


def read(run):
    return layers.mean_stage_ms(run, "bond_prediction")
