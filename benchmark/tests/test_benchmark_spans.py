"""The program's spans in a trace (``spans.py``) and the readers of the
metrics made from them: idle time goes to the innermost ``mlcg.*`` span
open over each part of it, and a trace without such spans reads nothing."""

import types

import pytest

from conftest import ROOT  # noqa: F401  (puts the checkout on the path)

from benchmark import devtrace, harness, layers, spans


def _sample_trace(with_spans=True):
    """Two requests in a window of 1.2 s; idle [0, 0.1], [0.2, 0.4],
    [0.6, 0.9] and [1.0, 1.2]."""
    dev = [("edge_mlp_bf16_kernel<true>", 0.1, 0.2),
           ("sm90_xmma_gemm", 0.4, 0.6),
           ("Memcpy DtoH", 0.9, 1.0)]
    host = [("bench.unit", 0.0, 0.5), ("aten::copy_", 0.2, 0.25),
            ("bench.unit", 0.5, 1.0)]
    if with_spans:
        host += [("mlcg.request", 0.0, 0.45),
                 ("mlcg.edm_sampling", 0.0, 0.4),
                 ("mlcg.sample.prelude", 0.0, 0.15),
                 ("mlcg.sample.table", 0.05, 0.1),
                 ("mlcg.sample.trajectory", 0.15, 0.3),
                 ("mlcg.sample.to_host", 0.3, 0.4),
                 ("mlcg.request", 0.5, 0.95),
                 ("mlcg.sample.prelude", 0.55, 0.8),
                 ("mlcg.sample.to_host", 0.8, 0.95)]
    return devtrace.Trace(dev, host, (0.0, 1.2), [(0.0, 0.5), (0.5, 1.0)])


def _train_trace(with_spans=True):
    """One step whose device work [0.35, 0.7] lags its host work."""
    dev = [("edge_mlp_f32_kernel<true>", 0.35, 0.7)]
    host = [("bench.unit", 0.0, 0.6)]
    if with_spans:
        host += [("mlcg.data.wait", 0.0, 0.1),
                 ("mlcg.train.step", 0.1, 0.5),
                 ("mlcg.train.batch", 0.1, 0.2),
                 ("mlcg.train.draws", 0.2, 0.3),
                 ("mlcg.train.seed_sync", 0.22, 0.28),
                 ("mlcg.train.body", 0.3, 0.5),
                 ("mlcg.train.ema", 0.5, 0.6)]
    return devtrace.Trace(dev, host, (0.0, 0.7), [(0.0, 0.6)])


def _read(cell, metric, trace):
    return harness.Spec(cell).reader(metric).read(
        types.SimpleNamespace(trace=trace))


def test_idle_goes_to_the_innermost_span_by_time():
    tr = _sample_trace()
    got = spans.idle_by_chain(tr)
    req = ("mlcg.request",)
    edm = req + ("mlcg.edm_sampling",)
    want = {edm + ("mlcg.sample.prelude",): 0.05,
            edm + ("mlcg.sample.prelude", "mlcg.sample.table"): 0.05,
            # [0.2, 0.4] starts in the trajectory and ends in the copy
            edm + ("mlcg.sample.trajectory",): 0.1,
            edm + ("mlcg.sample.to_host",): 0.1,
            req + ("mlcg.sample.prelude",): 0.2,
            req + ("mlcg.sample.to_host",): 0.1,
            (): 0.2}
    assert set(got) == set(want)
    for chain, t in want.items():
        assert got[chain] == pytest.approx(t), chain
    # the parts add up to the device's idle share
    run = types.SimpleNamespace(trace=tr)
    assert 100 * sum(got.values()) / tr.window_s == pytest.approx(
        layers.idle(run))


def test_train_idle_by_span():
    got = spans.idle_by_chain(_train_trace())
    step = ("mlcg.train.step",)
    assert got[("mlcg.data.wait",)] == pytest.approx(0.1)
    assert got[step + ("mlcg.train.batch",)] == pytest.approx(0.1)
    assert got[step + ("mlcg.train.draws",)] == pytest.approx(0.04)
    assert got[step + ("mlcg.train.draws", "mlcg.train.seed_sync")] == (
        pytest.approx(0.06))
    assert got[step + ("mlcg.train.body",)] == pytest.approx(0.05)
    assert got[()] == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("cell, metric, value", [
    ("sample-bf16-interactive", "sample_prelude_ms", 200.0),
    ("sample-bf16-interactive", "sample_wait_ms", 125.0),
    ("sample-bf16-interactive", "idle_prelude.sample", 100 * 0.3 / 1.2),
    ("train-f32-b64", "train_host_ms", 400.0),
    ("train-f32-b64", "idle_host.train", 100 * 0.3 / 0.7),
])
def test_readers(cell, metric, value):
    trace = (_train_trace if cell.startswith("train") else _sample_trace)()
    assert _read(cell, metric, trace) == pytest.approx(value)
    # a program without the spans (and a run without a trace) reads nothing
    bare = (_train_trace if cell.startswith("train") else _sample_trace)(
        with_spans=False)
    assert _read(cell, metric, bare) is None
    assert _read(cell, metric, None) is None


def test_a_trace_without_device_events_reads_no_idle():
    tr = _sample_trace()
    tr.device = []
    assert spans.idle_by_chain(tr) is None
    assert _read("sample-bf16-interactive", "idle_prelude.sample", tr) is None
    assert _read("sample-bf16-interactive", "sample_prelude_ms",
                 tr) == pytest.approx(200.0)
