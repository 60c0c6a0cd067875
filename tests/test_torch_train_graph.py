"""The port's one-program train steps, in the form the card captures, on the CPU.

On the card a train step's device body (the loss from pre-drawn draws, its
backward, the AdamW update that reads its learning rate from a tensor), the
EMA update and AdjMatSeer's step each run as a captured CUDA graph
(``training/step.py``, ``loop.py``, ``bonds.py``; ``utils/cuda_graph.py``).
Here the same bodies run eagerly on CPU tensors, the route CPU tensors take,
and are held bit for bit against the loops they replace (written out below
as they stood: draws inside the loss, AdamW and Adam with a float learning
rate), in float32 and float64, and against the JAX package's jitted step,
EMA and AdjMatSeer step in float64 at the bars of
``tests/test_torch_training.py`` and ``test_torch_training_data.py``. The
capture itself runs only on the card (``chip_smoke.py`` phase 21).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_conformer_generator_tpu.config import DiffusionConfig as JDiff
from ml_conformer_generator_tpu.parallel.mesh import make_mesh as jax_mesh
from ml_conformer_generator_tpu.training.step import \
    make_optimizer as jax_make_optimizer
from ml_conformer_generator_tpu.training.step import \
    make_train_step as jax_make_train_step
from ml_conformer_generator_tpu_torch.checkpoint import to_jax_params
from ml_conformer_generator_tpu_torch.chem.mol import Molecule
from ml_conformer_generator_tpu_torch.chem.smiles import from_smiles
from ml_conformer_generator_tpu_torch.config import (AdjMatSeerConfig,
                                                     DiffusionConfig,
                                                     EGNNConfig)
from ml_conformer_generator_tpu_torch.diffusion.schedule import gamma_schedule
from ml_conformer_generator_tpu_torch.models.adj_mat_seer import AdjMatSeer
from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
from ml_conformer_generator_tpu_torch.parallel.edge_shard import \
    dynamics_forward_sharded
from ml_conformer_generator_tpu_torch.parallel.mesh import Mesh, make_mesh
from ml_conformer_generator_tpu_torch.parallel.sampler import data_stream
from ml_conformer_generator_tpu_torch.training import bonds as tbonds
from ml_conformer_generator_tpu_torch.training import loss as tloss
from ml_conformer_generator_tpu_torch.training import step as tstep
from ml_conformer_generator_tpu_torch.training import (MoleculeDataset,
                                                       edm_training_loss,
                                                       init_train_state,
                                                       make_optimizer,
                                                       make_train_step,
                                                       train_adj_mat_seer)
from ml_conformer_generator_tpu_torch.training.loop import (ema_decay_at,
                                                            ema_graph_body,
                                                            ema_update_)
from ml_conformer_generator_tpu_torch.utils.cuda_graph import GraphCache
from test_torch_training import _assert_trees_close, _jax_draws, _models
from test_torch_training_data import _bond_mols

WIDTH, BLOCKS, T, B, N = 32, 2, 10, 4, 9
STEPS = 5
# (total steps, warmup): constant, and a warmup-cosine that crosses its
# warmup within STEPS
SCHEDULES = {"constant": (0, 0), "warmup_cosine": (8, 2)}


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _mols(rng, n_mols):
    """Chains of 5 to N atoms of C, N and O."""
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(5, N + 1))
        out.append(Molecule(rng.choice([6, 7, 8], size=n),
                            rng.standard_normal((n, 3)) * 1.5,
                            [(i, i + 1, 1) for i in range(n - 1)]))
    return out


def _batches(dtype, n=STEPS, seed=0):
    """``n`` batches of B molecules of up to N atoms from the port's data
    pipeline."""
    ds = MoleculeDataset(_mols(np.random.default_rng(seed), B * n),
                         min_n_nodes=5, max_n_nodes=N)
    return [{k: torch.as_tensor(v).to(dtype)
             for k, v in ds.featurize(list(range(i * B, (i + 1) * B)),
                                      N).items()} for i in range(n)]


def _model(dtype, seed=1):
    return EGNNDynamics(EGNNConfig(hidden_nf=WIDTH, n_blocks=BLOCKS),
                        torch.Generator().manual_seed(seed)).to(dtype)


def _todays_step(cfg, diff, mesh):
    """The train step before its split (the loop it replaces): the draws
    inside the loss, the mesh's denoiser, ``backward``, the optimizer's and
    the schedule's steps."""
    cfg = EGNNConfig(hidden_nf=cfg.hidden_nf, n_blocks=cfg.n_blocks,
                     remat=True)
    dynamics_fn = functools.partial(dynamics_forward_sharded, mesh=mesh)

    def step(model, opt, sched, generator, batch, gamma):
        opt.zero_grad(set_to_none=True)
        loss, metrics = edm_training_loss(
            model, data_stream(generator, 0, "cpu"), batch["x"], batch["h"],
            batch["node_mask"], batch["edge_mask"], batch["context"], gamma,
            cfg, diff, dynamics_fn=dynamics_fn)
        loss.backward()
        opt.step()
        sched.step()
        return metrics

    return step


def _todays_optimizer(model, lr, total, warmup):
    """The optimizer before the split, in the fused form: a Python float
    learning rate and its ``LambdaLR``. (The fused AdamW and the
    single-tensor one the loop had on the CPU differ in the last bit of
    some updates; both are held to optax in
    ``test_torch_training.py::test_optimizer_matches_optax_f64``.)"""
    schedule = make_optimizer(lr=lr, total_steps=total,
                              warmup_steps=warmup).schedule
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-12, fused=True)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / lr)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_split_step_is_todays_loop(dtype, schedule):
    """``make_train_step``'s host work (the draws from ``data_stream`` in
    the loop's order) and device body (the loss from those draws, the fused
    AdamW reading its learning rate from a tensor that the schedule fills)
    against the loop they replace (the same fused AdamW with a Python float
    learning rate), over STEPS steps: every loss, mean t, parameter,
    gradient, optimizer moment and step count and learning rate bit for
    bit."""
    total, warmup = SCHEDULES[schedule]
    cfg, diff = EGNNConfig(hidden_nf=WIDTH, n_blocks=BLOCKS), \
        DiffusionConfig(timesteps=T)
    gamma = torch.from_numpy(gamma_schedule(T)).to(dtype)
    batches = _batches(dtype)
    new, old = _model(dtype), _model(dtype)
    state = init_train_state(new, make_optimizer(
        lr=3e-3, total_steps=total, warmup_steps=warmup))
    opt, sched = _todays_optimizer(old, 3e-3, total, warmup)
    mesh = make_mesh(device="cpu")
    step, loop = make_train_step(mesh, cfg, diff), \
        _todays_step(cfg, diff, mesh)
    g_new, g_old = torch.Generator().manual_seed(7), \
        torch.Generator().manual_seed(7)
    for batch in batches:
        m_new = step(new, state, g_new, batch, gamma)
        m_old = loop(old, opt, sched, g_old, batch, gamma)
        for k in ("loss", "mean_t"):
            assert torch.equal(m_new[k], m_old[k]), k
        assert float(state.optimizer.param_groups[0]["lr"]) == \
            opt.param_groups[0]["lr"]
        for (name, p), q in zip(new.named_parameters(), old.parameters()):
            assert torch.equal(p, q), name
            assert torch.equal(p.grad, q.grad), name
            a, b = state.optimizer.state[p], opt.state[q]
            for key in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(a[key], b[key]), (name, key)
            assert float(a["step"]) == float(b["step"])
    assert torch.equal(g_new.get_state(), g_old.get_state())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_ema_graph_body_is_ema_update(dtype):
    """The EMA graph's arithmetic (``ema_graph_body``: foreach products by
    the device pair (d, 1 - d) in the weights' type) against
    ``ema_update_``'s loop of Python-float products, bit for bit over
    steps whose decay crosses its warmup."""
    model = _model(dtype)
    ema = copy.deepcopy(model).requires_grad_(False)
    twin = copy.deepcopy(ema)
    rng = np.random.default_rng(0)
    for t in range(6):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(torch.tensor(rng.standard_normal(tuple(p.shape)),
                                    dtype=dtype))
        d = ema_decay_at(0.999, t)
        with torch.no_grad():
            ema_graph_body(list(twin.parameters()), list(model.parameters()),
                           torch.tensor([d, 1.0 - d], dtype=dtype))
        ema_update_(ema, model, 0.999, t)
        for a, b in zip(ema.parameters(), twin.parameters()):
            assert torch.equal(a, b)


def test_steps_and_ema_match_jax_f64(x64, monkeypatch):
    """Three steps of ``make_train_step`` with the EMA update after each,
    against JAX's jitted ``make_train_step`` and its loop's EMA formula
    (decay in float32) on the same draws: losses and gradients to 1e-10,
    parameters to 1e-12, the EMA to the bars of
    ``test_ema_matches_jax_formula``."""
    jcfg, params, dyn = _models(seed=3, remat=True)
    ema = copy.deepcopy(dyn).requires_grad_(False)
    batch = {k: v.numpy() for k, v in _batches(torch.float64, 1, 4)[0].items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    gamma = gamma_schedule(T).astype(np.float64)
    jstep = jax_make_train_step(jax_mesh((1, 1), devices=jax.devices()[:1]),
                                jcfg, JDiff(timesteps=T),
                                jax_make_optimizer())
    jopt = jax_make_optimizer().init(params)
    jema = params

    @jax.jit
    def jax_ema(e, p, t):
        d = jnp.minimum(0.999, (1.0 + t) / (10.0 + t))
        return jax.tree_util.tree_map(lambda a, q: d * a + (1.0 - d) * q,
                                      e, p)

    step = make_train_step(make_mesh(device="cpu"),
                           EGNNConfig(hidden_nf=jcfg.hidden_nf,
                                      n_blocks=jcfg.n_blocks),
                           DiffusionConfig(timesteps=T))
    state = init_train_state(dyn)
    for t in range(3):
        key = jax.random.PRNGKey(20 + t)
        params, jopt, jm = jstep(params, jopt, key, jb, jnp.asarray(gamma))
        jema = jax_ema(jema, params, jnp.float32(t))
        t_int, eps = _jax_draws(jax.random.fold_in(key, 0), batch)
        monkeypatch.setattr(tloss, "_draws", lambda *a: (torch.tensor(t_int),
                                                         torch.tensor(eps)))
        m = step(dyn, state, torch.Generator(), batch, gamma)
        ema_update_(ema, dyn, 0.999, t)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-10, atol=1e-10)
        _assert_trees_close(to_jax_params(dyn), params, rtol=1e-12,
                            atol=1e-12)
        _assert_trees_close(to_jax_params(ema), jema, rtol=1e-6, atol=1e-7)


def _todays_bond_training(mols, steps, lr, batch_size, seed, cfg, model):
    """AdjMatSeer's loop before the split, the step inline, with the fused
    Adam. Returns the losses."""
    d_all = {k: torch.as_tensor(v) for k, v in
             tbonds.bond_training_batch(mols, cfg).items()}
    dtype = model.resize.weight.dtype
    d_all["dist"], d_all["adj"] = d_all["dist"].to(dtype), \
        d_all["adj"].to(dtype)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8, fused=True)
    rng = np.random.default_rng(seed)
    n = d_all["elements"].shape[0]
    losses = []
    for _ in range(steps):
        d = d_all
        if batch_size and batch_size < n:
            idx = torch.as_tensor(rng.choice(n, size=batch_size,
                                             replace=False))
            d = {k: v[idx] for k, v in d_all.items()}
        opt.zero_grad(set_to_none=True)
        loss = tbonds._bond_loss(model, d)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses


@pytest.mark.parametrize("batch_size", [0, 3], ids=["full", "sampled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_adj_mat_seer_step_is_its_loop(dtype, batch_size):
    """``train_adj_mat_seer``'s step body (fused Adam; on the card one
    graph) against the loop it replaces, full batch and sampled subsets
    from the same numpy rng: every loss and weight bit for bit."""
    cfg = AdjMatSeerConfig(n_hidden=32)
    mols = _bond_mols(from_smiles)
    model = AdjMatSeer(cfg, torch.Generator().manual_seed(0)).to(dtype)
    twin = copy.deepcopy(model)
    out = train_adj_mat_seer(mols, steps=5, lr=3e-3, batch_size=batch_size,
                             seed=1, cfg=cfg, params=model, log_every=1,
                             log_fn=lambda s: None, device="cpu")
    losses = _todays_bond_training(mols, 5, 3e-3, batch_size, 1, cfg, twin)
    assert [h["loss"] for h in out["history"]] == losses
    for p, q in zip(model.parameters(), twin.parameters()):
        assert torch.equal(p, q)


def test_lr_tensor_keeps_its_identity():
    """The learning rate a captured step reads is one tensor that the
    schedule fills in place: the same object after every
    ``scheduler.step()``, holding the schedule's value."""
    model = _model(torch.float32)
    recipe = make_optimizer(lr=1e-3, total_steps=8, warmup_steps=3)
    state = init_train_state(model, recipe)
    lr = state.optimizer.param_groups[0]["lr"]
    assert torch.is_tensor(lr) and lr.dtype == torch.float64    # the CPU's
    assert state.optimizer.param_groups[0]["fused"]
    for count in range(1, 10):
        state.scheduler.step()
        assert state.optimizer.param_groups[0]["lr"] is lr
        np.testing.assert_allclose(float(lr), recipe.schedule(count),
                                   rtol=1e-6, atol=1e-12)


def test_more_than_one_rank_keeps_the_loop():
    """The step's graph needs the card and the (1, 1) mesh: a mesh of more
    than one rank all-reduces through gloo in its step, which a CUDA graph
    cannot capture, so its steps stay the loop, on the card too."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def mesh(shape, device):
        return Mesh({"data": shape[0], "edge": shape[1]}, 0, 0, device)

    assert tstep._graphed_on(mesh((1, 1), cuda))
    for shape in ((1, 2), (2, 1), (2, 2)):
        assert not tstep._graphed_on(mesh(shape, cuda)), shape
    assert not tstep._graphed_on(mesh((1, 1), cpu))


def test_capture_of_the_step_raises_on_cpu_tensors():
    """The step's capture takes CUDA tensors: on CPU tensors it raises
    before it runs a step, and nothing falls back to the eager body."""
    model = _model(torch.float32)
    state = init_train_state(model)
    before = [p.detach().clone() for p in model.parameters()]
    ran = []
    batch = _batches(torch.float32, 1)[0]
    inputs = dict(batch, gamma=torch.from_numpy(gamma_schedule(T)),
                  t_int=torch.zeros(B, dtype=torch.int64),
                  eps=torch.zeros(B, N, 11))
    with pytest.raises(ValueError, match="CUDA"):
        tstep._graph_step(GraphCache(1), lambda **k: ran.append(1), model,
                          state, inputs)
    assert not ran
    assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_replayed_weights_are_packed_again():
    """A graph that updates weights in place increments their versions on
    each replay (``CapturedGraph.writes``): the W1 pack cache then packs
    the new values on the next eager call instead of serving the old
    pack."""
    w1 = torch.tensor(np.random.default_rng(0).standard_normal((64, 64)),
                      dtype=torch.float32)
    old = gk.packed_w1(w1)
    assert gk.packed_w1(w1) is old
    with torch.no_grad():
        w1.data.mul_(0.5)                    # as a replay writes: no bump
    torch.autograd.graph.increment_version((w1,))
    new = gk.packed_w1(w1)
    assert new is not old and torch.equal(new, gk.pack_w1(w1))


def test_captured_tallies_are_per_stream_and_credit_packs():
    """Launches and W1 packs recorded under capture are tallied by the
    capturing stream (a captured backward records from the autograd
    engine's thread onto that stream), and a replay's credit adds the
    packs to PACKS."""
    assert gk.captured_launches(101) is gk.captured_launches(101)
    assert gk.captured_launches(101) is not gk.captured_launches(102)
    assert gk.captured_reads(101) is not gk.captured_reads(102)
    gk.reset_launch_counts()
    gk.reset_pack_count()
    gk.credit_launches({"gcl": 36, "coord": 18, "gcl_bwd": 18,
                        "coord_bwd": 9, "packs": 27})
    assert gk.LAUNCHES == {"gcl": 36, "coord": 18, "gcl_bwd": 18,
                           "coord_bwd": 9}
    assert gk.PACKS == 27
    gk.reset_launch_counts()
    gk.reset_pack_count()


def test_the_optimizer_step_moves_the_weights_versions():
    """The fused AdamW writes the weights without moving their version
    counters; the state's optimizer moves them after each step (eager, and
    in a graph's capture), so the W1 pack cache repacks a weight the
    update changed."""
    model = _model(torch.float32)
    state = init_train_state(model)
    w1 = model.egnn.e_block_0.gcl_0.edge_mlp[2].weight
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    old = gk.packed_w1(w1)
    versions = [p._version for p in model.parameters()]
    state.optimizer.step()
    assert all(p._version > v for p, v in zip(model.parameters(), versions))
    assert gk.packed_w1(w1) is not old
