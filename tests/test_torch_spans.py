"""The port's spans (``utils/metrics.py``): off, one shared no-op; under
``torch.profiler``, host ranges named ``mlcg.*`` on the calling thread,
nested at the layer boundaries of a request and of a train step, with the
stage spans on the same boundaries as ``last_metrics``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ml_conformer_generator_tpu_torch.chem.mol import Molecule
from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                     EGNNConfig)
from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
from ml_conformer_generator_tpu_torch.diffusion.schedule import gamma_schedule
from ml_conformer_generator_tpu_torch.generator import MLConformerGenerator
from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
from ml_conformer_generator_tpu_torch.parallel import make_mesh
from ml_conformer_generator_tpu_torch.training import (MoleculeDataset,
                                                       init_train_state,
                                                       make_train_step,
                                                       prefetch)
from ml_conformer_generator_tpu_torch.training.loop import ema_update_
from ml_conformer_generator_tpu_torch.utils.cuda_graph import GraphCache
from ml_conformer_generator_tpu_torch.utils.metrics import (StageTimer,
                                                            span, spanned)

CFG = EGNNConfig(hidden_nf=16, n_blocks=1)


def _spans(prof):
    """(name, start ns, end ns, thread) of every ``mlcg.*`` event."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("mlcg.")]


def _nesting(spans):
    """{(span, its innermost enclosing span or None)} of one thread."""
    out = set()
    for i, (n, s, e, _) in enumerate(spans):
        outer = [(s2, -e2, n2) for j, (n2, s2, e2, _) in enumerate(spans)
                 if j != i and s2 <= s and e <= e2]
        out.add((n, max(outer)[2] if outer else None))
    return out


def test_span_off_is_one_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = span("mlcg.a"), span("mlcg.b")
    assert a is b
    with a:
        with b:
            pass
    timer = StageTimer()
    with timer.stage("x"):
        pass
    assert set(timer.summary()) == {"x_s", "total_s"}
    assert spanned("mlcg.f")(lambda v: v + 1)(1) == 2


def test_stage_is_a_span_and_capture_spans_a_miss():
    timer, cache = StageTimer(), GraphCache(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert span("mlcg.a") is not span("mlcg.a")
        with timer.stage("outer"):
            cache.get("k", 0, lambda: "graph")
            cache.get("k", 0, lambda: "other")
    spans = _spans(prof)
    assert _nesting(spans) == {("mlcg.outer", None),
                               ("mlcg.graph.capture", "mlcg.outer")}
    assert [n for n, *_ in spans].count("mlcg.graph.capture") == 1
    assert cache.captures == 1


def _generator():
    gen = MLConformerGenerator(diffusion_steps=3, seed=0, device="cpu")
    gen.sampler = EDMSampler(EGNNDynamics(CFG, torch.Generator().manual_seed(0)),
                             gen.diff_cfg)
    return gen


def test_request_spans_nest_on_one_thread():
    gen = _generator()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gen.generate_conformers(reference_context=[105.0, 473.0, 537.0],
                                n_atoms=18, n_samples=3)
    spans = _spans(prof)
    assert len({t for *_, t in spans}) == 1
    assert _nesting(spans) == {
        ("mlcg.request", None),
        ("mlcg.edm_sampling", "mlcg.request"),
        ("mlcg.featurize", "mlcg.request"),
        ("mlcg.bond_prediction", "mlcg.request"),
        ("mlcg.standardize", "mlcg.request"),
        ("mlcg.sample.prelude", "mlcg.edm_sampling"),
        ("mlcg.sample.table", "mlcg.sample.prelude"),
        ("mlcg.sample.trajectory", "mlcg.edm_sampling"),
        ("mlcg.sample.to_host", "mlcg.edm_sampling"),
        ("mlcg.sample.decode", "mlcg.edm_sampling")}
    # the stage spans are last_metrics' stages, whose keys are unchanged
    assert set(gen.last_metrics) == {
        "edm_sampling_s", "featurize_s", "bond_prediction_s",
        "standardize_s", "requested", "valid", "total_s"}
    by_name = {}
    for n, s, e, _ in spans:
        by_name.setdefault(n, []).append(1e-9 * (e - s))
    assert by_name["mlcg.edm_sampling"][0] == pytest.approx(
        gen.last_metrics["edm_sampling_s"], abs=5e-4)
    parts = sum(sum(by_name[f"mlcg.sample.{k}"])
                for k in ("prelude", "trajectory", "to_host", "decode"))
    assert parts >= 0.95 * by_name["mlcg.edm_sampling"][0]


def test_request_without_profiler_records_the_same_metrics():
    gen = _generator()
    gen.generate_conformers(reference_context=[105.0, 473.0, 537.0],
                            n_atoms=18, n_samples=2)
    assert set(gen.last_metrics) == {
        "edm_sampling_s", "featurize_s", "bond_prediction_s",
        "standardize_s", "requested", "valid", "total_s"}


def _mols(n_mols=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(15, 20))
        out.append(Molecule(rng.choice([6, 7, 8], size=n),
                            rng.standard_normal((n, 3)) * 2, []))
    return out


def test_train_step_ema_and_batch_wait_spans():
    ds = MoleculeDataset(_mols(), max_n_nodes=20)
    feed = prefetch(iter([ds.featurize([0, 1], 20), ds.featurize([2, 3],
                                                                  20)]))
    model = EGNNDynamics(CFG, torch.Generator().manual_seed(0))
    ema = EGNNDynamics(CFG, torch.Generator().manual_seed(0))
    diff = DiffusionConfig(timesteps=4)
    step = make_train_step(make_mesh(device="cpu"), CFG, diff)
    state = init_train_state(model)
    gamma = torch.as_tensor(gamma_schedule(4), dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch = next(feed)
        step(model, state, torch.Generator().manual_seed(1), batch, gamma)
        ema_update_(ema, model, 0.999, 0)
    spans = _spans(prof)
    assert len({t for *_, t in spans}) == 1
    assert _nesting(spans) == {
        ("mlcg.data.wait", None),
        ("mlcg.train.step", None),
        ("mlcg.train.batch", "mlcg.train.step"),
        ("mlcg.train.draws", "mlcg.train.step"),
        ("mlcg.train.seed_sync", "mlcg.train.draws"),
        ("mlcg.train.body", "mlcg.train.step"),
        ("mlcg.train.ema", None)}
