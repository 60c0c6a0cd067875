"""EDM GEOM-Drugs training on the port: the all-atom data pipeline
(hydrogens kept, each batch padded to its largest molecule's bucket, no
context), the train step and EMA against the plain reference of EDM's step
(``benchmark/reference/train_drugs.py``) in float64 at a small width, the
step's graphs kept one per batch shape, the float32 backward's tiles past
128 nodes, and ``training.train`` on all-atom batches."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread)
from benchmark.reference import edm as ref_edm, train_drugs as ref_train
from ml_conformer_generator_tpu_torch.chem.mol import Molecule
from ml_conformer_generator_tpu_torch.config import (
    GEOM_DRUGS_ATOM_DECODER, edm_geom_drugs)
from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
from ml_conformer_generator_tpu_torch.parallel import make_mesh
from ml_conformer_generator_tpu_torch.training import (
    AllAtomDataset, MoleculeDataset, batches, train)
from ml_conformer_generator_tpu_torch.training import step as tstep
from ml_conformer_generator_tpu_torch.training.loop import ema_update_
from ml_conformer_generator_tpu_torch.utils.cuda_graph import GraphCache

T = 10
DECODER = [GEOM_DRUGS_ATOM_DECODER[c] for c in range(16)]
#: The reference's configuration at the test's small width.
REF = dict(hidden_nf=32, n_blocks=2, inv_sublayers=1, norm_constant=1.0,
           coords_range=15.0, normalization_factor=1.0, timesteps=T,
           noise_precision=1e-5, schedule_power=2,
           norm_values=[1.0, 4.0, 10.0], atom_decoder=DECODER, node_bucket=8)


def _cfgs():
    egnn_cfg, diff_cfg = edm_geom_drugs("float32", timesteps=T)
    return dataclasses.replace(egnn_cfg, hidden_nf=32, n_blocks=2), diff_cfg


def _mols(rng, sizes, elements=(1, 6, 7, 8, 9, 16, 17, 35)):
    out = []
    for n in sizes:
        z = rng.choice(elements, size=n)
        steps = rng.standard_normal((n, 3))
        steps *= 1.2 / np.linalg.norm(steps, axis=1, keepdims=True)
        out.append(Molecule(z, np.cumsum(steps, 0) + 3.0, []))
    return out


def test_all_atom_batches_keep_hydrogens_and_pad_to_their_largest():
    rng = np.random.default_rng(0)
    mols = _mols(rng, [5, 13, 9, 3])
    mols[0].atomic_nums[:] = 1                        # all hydrogens
    outside = Molecule(np.array([6, 11, 6]), np.zeros((3, 3)), [])  # Na
    big = _mols(rng, [182])[0]
    ds = AllAtomDataset(mols + [outside, big])
    assert len(ds) == 4
    b = ds.featurize([0, 1, 2])
    assert b["x"].shape == (3, 16, 3) and b["h"].shape == (3, 16, 16)
    assert b["context"].shape == (3, 16, 0)
    assert b["node_mask"][:, :, 0].sum(1).tolist() == [5, 13, 9]
    # hydrogens are class 0, one-hot on every real atom, zeros past them
    assert (b["h"][0, :5, 0] == 1).all() and b["h"][0].sum() == 5
    assert (b["h"].sum(-1) == b["node_mask"][..., 0]).all()
    classes = {v: k for k, v in GEOM_DRUGS_ATOM_DECODER.items()}
    from ml_conformer_generator_tpu_torch.chem.periodic import symbol
    want = [classes[symbol(int(z))] for z in mols[1].atomic_nums]
    assert b["h"][1, :13].argmax(-1).tolist() == want
    # zero centre of mass over the real atoms; no self-edges
    np.testing.assert_allclose(b["x"][1, :13].mean(0), 0.0, atol=1e-5)
    assert (b["x"][1, 13:] == 0).all()
    assert (np.einsum("bii->b", b["edge_mask"][..., 0]) == 0).all()
    assert b["edge_mask"][2, :9, :9, 0].sum() == 9 * 8
    # a batch of small molecules pads to its own bucket, 181 atoms to 184
    assert ds.featurize([3, 0])["x"].shape[1] == 8
    assert AllAtomDataset(_mols(rng, [181])).featurize([0])["x"].shape[1] \
        == 184
    # batches() pads an all-atom batch to its own largest, a MoleculeDataset
    # batch to the dataset's
    shapes = {bb["x"].shape[1] for bb in batches(
        AllAtomDataset(_mols(rng, [3, 4, 20, 21])), 2,
        rng=np.random.default_rng(1))}
    assert shapes <= {8, 24} and 24 in shapes
    heavy = MoleculeDataset(_mols(rng, [16, 17, 20, 18],
                                  elements=(6, 7, 8)))
    assert {bb["x"].shape[1] for bb in batches(heavy, 2)} == {39}


def _as_torch(batch):
    return {k: torch.as_tensor(v.astype(np.float64)) for k, v in
            batch.items()}


def test_train_step_and_ema_match_the_reference_f64():
    """Two steps (pads 16 and 8) and their EMA updates, the port's step on
    the CPU in float64 against the reference's (run in blocks of 3
    molecules, each cut to its largest): each loss, each step's
    gradients, the weights and the average after both, to 1e-10."""
    egnn_cfg, diff_cfg = _cfgs()
    model = EGNNDynamics(egnn_cfg, torch.Generator().manual_seed(3)).double()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("coord_mlp.4.weight"):
                p.copy_(torch.randn(p.shape, generator=g,
                                    dtype=torch.float64) * 0.3)
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(5)
    mols = _mols(rng, [7, 14, 5, 10]) + _mols(rng, [6, 3, 8, 4])
    ds = AllAtomDataset(mols)
    feats = [ds.featurize([0, 1, 2, 3]), ds.featurize([4, 5, 6, 7])]
    assert [f["x"].shape[1] for f in feats] == [16, 8]
    for f, part in zip(feats, (mols[:4], mols[4:])):
        ref_batch = ref_train.featurize(
            [(m.atomic_nums, m.coords) for m in part], REF, "cpu")
        for k, v in ref_batch.items():
            np.testing.assert_allclose(v.numpy(), f[k], atol=1e-6)

    state = tstep.init_train_state(model, tstep.make_optimizer(
        lr=1e-2, weight_decay=1e-12))
    step = tstep.make_train_step(make_mesh(device="cpu"), egnn_cfg, diff_cfg)
    # the reference's float64 schedule (the port's table is float32)
    gamma = torch.from_numpy(ref_edm.gamma_schedule(T, 1e-5, 2))
    ema = EGNNDynamics(egnn_cfg).double().requires_grad_(False)
    ema.load_state_dict(w0)
    gen = torch.Generator().manual_seed(6)
    losses, grads = [], []
    for s, f in enumerate(feats):
        batch = {k: v.astype(np.float64) for k, v in f.items()}
        losses.append(float(step(model, state, gen, batch, gamma)["loss"]))
        ema_update_(ema, model, 0.9999, s)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})

    r_losses, r_grads, r_weights, r_ema = ref_train.run_steps(
        w0, REF, [_as_torch(f) for f in feats],
        torch.Generator().manual_seed(6), 2, 1e-2, 1e-12, 0.9999, rows=3)
    r_after = r_weights[-1]
    np.testing.assert_allclose(losses, r_losses, rtol=1e-10)
    after = dict(model.named_parameters())
    ema_after = dict(ema.named_parameters())
    for name in r_after:
        for got, want in zip(grads, r_grads):
            scale = max(1.0, want[name].abs().max().item())
            assert (got[name] - want[name]).abs().max() < 1e-10 * scale, name
        assert (after[name] - r_after[name]).abs().max() < 1e-10, name
        assert (ema_after[name] - r_ema[name]).abs().max() < 1e-10, name
    # the steps moved the weights, and the average followed
    assert max((after[n] - w0[n]).abs().max().item() for n in w0) > 1e-3
    assert max((ema_after[n] - w0[n]).abs().max().item() for n in w0) > 1e-4


def test_reference_steps_forced_to_another_runs_weights():
    """The reference's steps forced to another run's weights (the
    benchmark's judge of the drugs training cell): forced to its own free
    run's weights, every loss, gradient, weight and the average are its
    free run's bit for bit; forced to weights moved off them, each step's
    gradient is taken at the forced weights, and the average follows
    them."""
    egnn_cfg, _ = _cfgs()
    model = EGNNDynamics(egnn_cfg, torch.Generator().manual_seed(7)).double()
    w0 = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(8)
    mols = _mols(rng, [5, 9, 4, 7, 6, 3])
    ds = AllAtomDataset(mols)
    feats = [_as_torch(ds.featurize(idx)) for idx in ([0, 1, 2], [3, 4, 5])]
    steps = lambda **k: ref_train.run_steps(
        w0, REF, feats, torch.Generator().manual_seed(9), 2, 1e-2, 1e-12,
        0.9999, rows=2, **k)
    free = steps()
    forced = steps(forced=[w0] + free[2])
    assert free[0] == forced[0]
    for a, b in zip(free[1] + free[2] + [free[3]],
                    forced[1] + forced[2] + [forced[3]]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    moved = [w0] + [{k: v + 1e-3 for k, v in w.items()} for w in free[2]]
    off = steps(forced=moved)
    assert off[0][0] == free[0][0] and off[0][1] != free[0][1]
    # the forced second step is a free step from the moved weights, at the
    # stream's second draws
    g = torch.Generator().manual_seed(9)
    B, N, _ = feats[0]["node_mask"].shape
    ref_train.step_draws(g, B, N, feats[0]["node_mask"], T, len(DECODER))
    again = ref_train.run_steps(moved[1], REF, feats[1:], g, 1, 1e-2, 1e-12,
                                0.9999, rows=2)
    assert again[0][0] == off[0][1]
    assert all(torch.equal(again[1][0][k], off[1][1][k]) for k in w0)
    ema = {k: v.clone() for k, v in w0.items()}
    for s in range(2):
        ref_train.train.ema_update(ema, moved[s + 1], 0.9999, s)
    assert all(torch.equal(ema[k], off[3][k]) for k in ema)


def test_step_graphs_are_kept_one_per_shape():
    """The train step's graphs: a cache of one per batch shape the
    dataset's batches take (every node bucket through 184 for all-atom
    batches, the least kept for batches of one shape), sharing one memory
    pool; a shape seen again is served, not captured."""
    egnn_cfg, diff_cfg = _cfgs()
    mesh = make_mesh(device="cpu")
    shapes = AllAtomDataset([]).batch_shapes
    assert shapes == len(range(8, 185, 8)) == 23
    assert MoleculeDataset([]).batch_shapes == 1
    one = tstep.make_train_step(mesh, egnn_cfg, diff_cfg)
    assert one.graphs.maxsize == tstep.GRAPHS_KEPT
    step = tstep.make_train_step(mesh, egnn_cfg, diff_cfg,
                                 batch_shapes=shapes)
    assert step.graphs.maxsize == shapes
    assert step.graphs.shared_pool and one.graphs.shared_pool
    cache = GraphCache(step.graphs.maxsize, shared_pool=True)
    made = []
    shapes = list(range(8, 185, 8))
    for _ in range(2):
        for n in shapes:
            cache.get(("step", n), "token", lambda: made.append(n) or n)
    assert made == shapes and len(cache) == len(shapes)
    assert cache.captures == len(shapes)
    assert cache.captures_by_key == {("step", n): 1 for n in shapes}
    cache.get(("step", 8), "moved", lambda: made.append(8) or 8)
    assert cache.captures_by_key[("step", 8)] == 2
    assert GraphCache(2).pool_handle() is None


@pytest.mark.parametrize("N,ti,tpg", [(129, 8, 17), (144, 8, 18),
                                      (184, 2, 92), (192, 2, 96)])
def test_backward_tiles_of_wide_graphs(N, ti, tpg):
    """Past 128 nodes a backward work item holds as many target nodes as
    share the tail tile (TI (N - 128) <= 128, at most 8); the dv partials
    are by work item."""
    assert gk.backward_tiles(N) == (ti, tpg)
    assert ti * (N - 128) <= 128 and ti * tpg >= N > ti * (tpg - 1)
    assert gk.backward_tiles(128) == (1, 128)


def test_train_loop_takes_all_atom_batches():
    """``training.train`` runs the drugs model on an all-atom dataset
    through its batches, prefetch, step and EMA chain; batches of several
    pads, finite losses, the EMA moved off the weights."""
    egnn_cfg, diff_cfg = _cfgs()
    rng = np.random.default_rng(7)
    ds = AllAtomDataset(_mols(rng, [4, 5, 11, 18, 6, 25, 9, 3]))
    seen = []
    featurize = ds.featurize
    ds.featurize = lambda idx, n_pad=None: seen.append(
        featurize(idx, n_pad)) or seen[-1]
    out = train(ds, egnn_cfg=egnn_cfg, diff_cfg=diff_cfg, batch_size=2,
                epochs=2, lr=1e-3, device="cpu", log_every=1,
                log_fn=lambda s: None, ema_decay=0.9999, seed=1)
    assert len(out["history"]) == 8
    assert np.isfinite([h["loss"] for h in out["history"]]).all()
    assert len({b["x"].shape[1] for b in seen}) > 1
    assert all(b["context"].shape[-1] == 0 for b in seen)
    moved = [(e - p).abs().max().item() for e, p in zip(
        out["ema_params"].parameters(), out["params"].parameters())]
    assert max(moved) > 0
