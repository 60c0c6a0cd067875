"""The form the port's CUDA graphs capture, held on the CPU.

On the card each trajectory of the sampler (generate, inpaint, merge) is one
captured CUDA graph, and FIRE's relaxation a captured graph of one step
replayed once a step (``utils/cuda_graph.py``). What a graph captures is a
function of static buffers: the sampler's ``EDMSampler.from_buffers`` reads
its scalars from a tensor table (with the stored reciprocals of alpha) and
its noise from one tensor of pre-drawn draws (``EDMSampler.buffers``);
FIRE's ``fire_graph_step`` updates its state in place and writes its branch
into a row of a history tensor (``_fire_graphed`` runs it as the replays
do). Here these forms run on CPU tensors and are held
bit for bit against the eager loop (the path CPU tensors take), in float32
and float64, and against the JAX package in float64 (JAX's draws replayed
as the buffer, as ``tests/test_torch_edm.py`` replays them through
``sample_noise``). The sampler's scalar tables are built once per
schedule and kept (``EDMSampler.table``): the tests below hold a kept table
to a fresh build and count the builds. The capture itself runs only on the
card (``chip_smoke.py`` phase 20).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one intra-op thread)
from ml_conformer_generator_tpu.chem import forcefield as jff
from ml_conformer_generator_tpu.chem.mol import Molecule as JMolecule
from ml_conformer_generator_tpu.config import DiffusionConfig as JDiffCfg
from ml_conformer_generator_tpu.config import EGNNConfig as JCfg
from ml_conformer_generator_tpu.diffusion.edm import EDMSampler as JSampler
from ml_conformer_generator_tpu_torch.chem import forcefield as tff
from ml_conformer_generator_tpu_torch.config import DiffusionConfig
from ml_conformer_generator_tpu_torch.diffusion.edm import (
    INV_ALPHA, INV_ALPHA_0, EDMSampler, alpha_of, n_draws, scalar_table,
    sigma_and_alpha_t_given_s)
from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk
from ml_conformer_generator_tpu_torch.parallel.sampler import \
    ShardedEDMSampler
from ml_conformer_generator_tpu_torch.utils.cuda_graph import (GraphCache,
                                                               capture)
from test_torch_forcefield import _batch, _molecules
from test_torch_inpaint import BLOCKS, T, WIDTH, Replay, _setup

# merge's diffusion level: below T, so it starts mid-schedule
LEVEL = 5
# The gentler table on which inpaint with two resamples stays finite at
# T = 8 with untrained weights (tests/test_torch_inpaint.py)
GENTLE = np.linspace(-11.5, 3.0, T + 1)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _case(trajectory, resample, dtype, seed=0):
    """The port's sampler at (B, N) = (2, 12), T = 8, width 32 x 9 blocks,
    in ``dtype``; the trajectory's static options and tensors; gamma."""
    gamma = GENTLE if trajectory == "inpaint" and resample > 1 else None
    s = _setup(seed=seed, gamma=gamma)
    sampler = EDMSampler(s["dyn"].to(dtype), DiffusionConfig(timesteps=T))
    names = ["node_mask", "edge_mask", "context"]
    if trajectory != "generate":
        names += ["z_known", "fixed_mask"]
    tensors = {n: torch.tensor(s[n], dtype=dtype) for n in names}
    static = dict(trajectory=trajectory, resample_steps=resample,
                  diffusion_level=LEVEL if trajectory == "merge" else 0,
                  t_dtype=torch.float64)
    return sampler, static, tensors, torch.tensor(s["gamma"]), s


def _loop(sampler, generator, gamma, static, tensors, dtype):
    """The public method of the trajectory on CPU tensors: the loop."""
    t = tensors
    if static["trajectory"] == "generate":
        return sampler.generate(generator, gamma, t["node_mask"],
                                t["edge_mask"], t["context"],
                                resample_steps=static["resample_steps"],
                                dtype=dtype)
    if static["trajectory"] == "inpaint":
        return sampler.inpaint(generator, gamma, t["node_mask"],
                               t["edge_mask"], t["context"], t["z_known"],
                               t["fixed_mask"],
                               resample_steps=static["resample_steps"],
                               dtype=dtype)
    return sampler.merge_fragments(
        generator, gamma, t["node_mask"], t["edge_mask"], t["fixed_mask"],
        t["context"], t["z_known"], diffusion_level=LEVEL,
        resample_steps=static["resample_steps"], dtype=dtype)


# -- the sampler ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("resampled", [False, True],
                         ids=["one_pass", "resampled"])
@pytest.mark.parametrize("trajectory", ["generate", "inpaint", "merge"])
def test_buffer_form_is_the_loop(trajectory, resampled, dtype):
    """The trajectory a graph captures, fed the table and the draws that
    ``buffers`` makes from a generator, equals the loop run from an equally
    seeded generator bit for bit on x and h; both generators end in the
    same state. Without resampling: generate's 0 and the fragment
    trajectories' least, 1; with: one more."""
    resample = int(resampled) + (trajectory != "generate")
    sampler, static, tensors, gamma, _ = _case(trajectory, resample, dtype)
    loop_gen = torch.Generator().manual_seed(7)
    want = _loop(sampler, loop_gen, gamma, static, tensors, dtype)
    buf_gen = torch.Generator().manual_seed(7)
    inputs = sampler.buffers(buf_gen, gamma, blend_power=3, dtype=dtype,
                             **static, **tensors)
    assert inputs["draws"].shape[0] == n_draws(
        trajectory, T, resample, static["diffusion_level"])
    assert inputs["table"].dtype == dtype
    got = sampler.from_buffers(static, **inputs)
    assert torch.isfinite(want[0]).all()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(buf_gen.get_state(), loop_gen.get_state())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_buffer_step_is_the_loop_step(dtype):
    """One reverse step with its scalars read from the table tensor (the
    stored 1 / alpha_{t|s} a 0-d tensor) equals ``sample_p_zs_given_zt``
    with the same draw, bit for bit, at every s."""
    sampler, _, t, gamma, _ = _case("generate", 0, dtype)
    table = torch.tensor(scalar_table(gamma, dtype), dtype=dtype)
    z = torch.randn(2, 12, 11, generator=torch.Generator().manual_seed(1),
                    dtype=dtype) * t["node_mask"]
    for s_idx in range(T):
        gen = torch.Generator().manual_seed(s_idx)
        want = sampler.sample_p_zs_given_zt(gen, z, s_idx, gamma,
                                            t["node_mask"], t["edge_mask"],
                                            t["context"])
        noise = sampler.sample_noise(torch.Generator().manual_seed(s_idx),
                                     2, 12, t["node_mask"], dtype)
        got = sampler._step(z, table[s_idx], lambda: noise, t["node_mask"],
                            t["edge_mask"], t["context"], gamma.dtype)
        assert torch.equal(got, want)


def test_table_holds_the_reciprocal_the_card_multiplies_by():
    """A CUDA division of a float32 tensor by a host float multiplies by
    the divisor's float32 reciprocal; the table stores that reciprocal
    (numpy's correctly rounded 1 / alpha in the latent's type), for every
    step and for the decode's alpha_0."""
    gamma = torch.tensor(GENTLE)
    for dtype, f in ((torch.float32, np.float32), (torch.float64, np.float64)):
        table = scalar_table(gamma, dtype)
        for s in range(T):
            _, _, alpha = sigma_and_alpha_t_given_s(gamma[s + 1], gamma[s])
            assert table[s][INV_ALPHA] == f(1) / f(alpha.item())
        alpha_0 = alpha_of(gamma[0]).item()
        assert table[T][INV_ALPHA_0] == f(1) / f(alpha_0)


def test_two_requests_in_a_row_are_the_loop_s():
    """Two requests from one generator through the buffers equal two loop
    requests from an equally seeded one: the first request leaves the
    generator where the loop leaves it."""
    dtype = torch.float32
    sampler, static, tensors, gamma, _ = _case("generate", 0, dtype, seed=3)
    loop_gen = torch.Generator().manual_seed(11)
    buf_gen = torch.Generator().manual_seed(11)
    for _ in range(2):
        want = _loop(sampler, loop_gen, gamma, static, tensors, dtype)
        got = sampler.from_buffers(static, **sampler.buffers(
            buf_gen, gamma, blend_power=3, dtype=dtype, **static, **tensors))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(buf_gen.get_state(), loop_gen.get_state())


def test_warm_up_form_runs_one_step():
    """``steps=1`` (the warm-up before a capture) runs one reverse step and
    the decode: two denoiser calls for generate, three for inpaint."""
    for trajectory, calls in (("generate", 2), ("inpaint", 3)):
        sampler, static, tensors, gamma, _ = _case(trajectory,
                                                   int(trajectory != "generate"),
                                                   torch.float32)
        inputs = sampler.buffers(torch.Generator().manual_seed(0), gamma,
                                 blend_power=3, dtype=torch.float32, **static,
                                 **tensors)
        seen = []
        phi = sampler.phi
        sampler.phi = lambda *a: seen.append(1) or phi(*a)
        x, _ = sampler.from_buffers(static, steps=1, **inputs)
        assert len(seen) == calls and torch.isfinite(x).all()


def _jax(trajectory, resample, s, key):
    sampler = JSampler(JCfg(hidden_nf=WIDTH, n_blocks=BLOCKS),
                       JDiffCfg(timesteps=T))
    j = {k: jnp.asarray(s[k]) for k in ("gamma", "node_mask", "edge_mask",
                                        "context", "z_known", "fixed_mask")}
    if trajectory == "generate":
        out = sampler.generate(s["params"], key, j["gamma"], j["node_mask"],
                               j["edge_mask"], j["context"],
                               resample_steps=resample)
        draws = Replay(j["node_mask"]).generate(key, resample)
    elif trajectory == "inpaint":
        out = sampler.inpaint(s["params"], key, j["gamma"], j["node_mask"],
                              j["edge_mask"], j["context"], j["z_known"],
                              j["fixed_mask"], resample_steps=resample)
        draws = Replay(j["node_mask"]).inpaint(key, resample)
    else:
        out = sampler.merge_fragments(
            s["params"], key, j["gamma"], j["node_mask"], j["edge_mask"],
            j["fixed_mask"], j["context"], j["z_known"],
            diffusion_level=LEVEL, resample_steps=resample)
        draws = Replay(j["node_mask"]).merge(key, LEVEL, resample)
    return [np.asarray(a) for a in out], np.stack(draws)


@pytest.mark.parametrize("trajectory,resample", [
    ("generate", 0), ("generate", 1), ("inpaint", 1), ("merge", 1)])
def test_buffer_form_matches_jax_f64(x64, trajectory, resample):
    """Float64, JAX's weights carried into the port: the captured form fed
    JAX's own draws as its buffer against JAX's ``EDMSampler`` within
    1e-10; h identical."""
    dtype = torch.float64
    sampler, static, tensors, gamma, s = _case(trajectory, resample, dtype)
    (xj, hj), draws = _jax(trajectory, resample, s, jax.random.PRNGKey(5))
    table = torch.tensor(scalar_table(
        gamma, dtype, diffusion_level=static["diffusion_level"]), dtype=dtype)
    with torch.no_grad():
        xt, ht = sampler.from_buffers(static, table=table,
                                      draws=torch.tensor(draws), **tensors)
    assert np.isfinite(xt.numpy()).all()
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(ht.numpy(), hj)


def _buffer_table(sampler, gamma, tensors, dtype=torch.float32,
                  blend_power=3, level=0):
    """The table tensor of a generate request's ``buffers``."""
    return sampler.buffers(torch.Generator().manual_seed(0), gamma,
                           trajectory="generate", resample_steps=0,
                           diffusion_level=level, t_dtype=gamma.dtype,
                           blend_power=blend_power, dtype=dtype,
                           **tensors)["table"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_buffers_build_one_table_per_schedule(dtype):
    """Two requests of one schedule read one table: built once, the same
    tensor both times, equal to the table made from ``scalar_table``'s
    rows as the per-request copy was."""
    sampler, _, tensors, gamma, _ = _case("generate", 0, dtype)
    first = _buffer_table(sampler, gamma, tensors, dtype)
    second = _buffer_table(sampler, gamma, tensors, dtype)
    assert sampler.table_builds == 1 and second is first
    assert torch.equal(first, torch.tensor(scalar_table(gamma, dtype),
                                           dtype=dtype))


@pytest.mark.parametrize("change,builds", [
    ("gamma_copy", 1), ("gamma_new", 2), ("gamma_in_place", 2),
    ("blend_power", 2), ("level", 2), ("level_past_T", 1), ("dtype", 2)])
def test_table_builds_again_only_for_another_schedule(change, builds):
    """A second request builds its table again when anything the table
    depends on differs: gamma's contents (a new tensor, or the same one
    edited in place), the blend power, the level it reads, the latent's
    type; an equal gamma in another tensor, or a level clamped to the same
    T, reuses the first. Each table equals a fresh build of its inputs."""
    sampler, _, tensors, gamma, _ = _case("generate", 0, torch.float32)
    gamma = gamma.clone()
    base = dict(dtype=torch.float32, blend_power=3, level=T)
    _buffer_table(sampler, gamma, tensors, **base)
    again = dict(base)
    if change == "gamma_copy":
        gamma = gamma.clone()
    elif change == "gamma_new":
        gamma = gamma + 0.5
    elif change == "gamma_in_place":
        gamma.add_(0.5)
    elif change == "blend_power":
        again["blend_power"] = 2
    elif change == "level":
        again["level"] = LEVEL
    elif change == "level_past_T":
        again["level"] = T + 3
    else:
        again["dtype"] = torch.float64
    got = _buffer_table(sampler, gamma, tensors, **again)
    assert sampler.table_builds == builds
    assert torch.equal(got, torch.tensor(scalar_table(
        gamma, again["dtype"], again["blend_power"], again["level"]),
        dtype=again["dtype"]))


@pytest.mark.parametrize("trajectory", ["generate", "merge"])
def test_loop_with_a_kept_table_is_a_fresh_sampler_s(trajectory):
    """On the loop (CPU tensors), two requests of a sampler that keeps its
    table equal those of a fresh sampler started at the same generator
    state, bit for bit; the generators end in the same state, and the
    table was built once."""
    dtype = torch.float32
    resample = int(trajectory != "generate")
    sampler, static, tensors, gamma, _ = _case(trajectory, resample, dtype)
    gen = torch.Generator().manual_seed(13)
    for _ in range(2):
        fresh = EDMSampler(sampler.dynamics, sampler.diff_cfg)
        fresh_gen = torch.Generator().set_state(gen.get_state())
        want = _loop(fresh, fresh_gen, gamma, static, tensors, dtype)
        got = _loop(sampler, gen, gamma, static, tensors, dtype)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(gen.get_state(), fresh_gen.get_state())
    assert sampler.table_builds == 1


def test_tables_kept_stay_at_the_bound():
    """More schedules than the sampler keeps: it keeps ``TABLES_KEPT``,
    the least recently used goes first, and only a schedule that went is
    built again."""
    sampler, _, tensors, gamma, _ = _case("generate", 0, torch.float32)
    kept = sampler.TABLES_KEPT
    for power in range(kept + 2):
        _buffer_table(sampler, gamma, tensors, blend_power=power)
        _buffer_table(sampler, gamma, tensors, blend_power=0)   # kept in use
    assert len(sampler._tables) == kept
    assert sampler.table_builds == kept + 2
    for power in [0, *range(3, kept + 2)]:
        _buffer_table(sampler, gamma, tensors, blend_power=power)
    assert sampler.table_builds == kept + 2
    _buffer_table(sampler, gamma, tensors, blend_power=1)          # went
    assert sampler.table_builds == kept + 3
    assert len(sampler._tables) == kept


def test_kept_tables_under_threads(monkeypatch):
    """Threads, more than the cores, ask one sampler for its schedules at
    once, with the interpreter switching threads often: every table equals
    a fresh build of its schedule; while the schedules fit in the sampler,
    each is built once however many threads ask for it first; with more
    than fit, ``table_builds`` counts every build made (a lost update would
    fall short) and the sampler keeps at most ``TABLES_KEPT``."""
    import os
    import sys
    import threading

    from ml_conformer_generator_tpu_torch.diffusion import edm

    sampler, _, _, gamma, _ = _case("generate", 0, torch.float32)
    built = []

    def counted(*args):
        built.append(1)
        return scalar_table(*args)

    monkeypatch.setattr(edm, "scalar_table", counted)
    want = {p: torch.tensor(scalar_table(gamma, torch.float32, p))
            for p in range(sampler.TABLES_KEPT + 4)}
    errors = []

    def ask(worker, powers):
        try:
            for i in range(24):
                p = powers[(worker * 7 + i * 5) % len(powers)]
                device = torch.device("cpu") if i % 2 else None
                got = sampler.table(gamma, torch.float32, p, device=device)
                if not torch.equal(torch.as_tensor(got, dtype=torch.float32),
                                   want[p]):
                    errors.append((worker, p))
        except Exception as e:     # a failure in a thread fails the test
            errors.append(e)

    def run(powers):
        threads = [threading.Thread(target=ask, args=(w, powers))
                   for w in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert errors == []

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        run(range(sampler.TABLES_KEPT))
        assert sampler.table_builds == len(built) == sampler.TABLES_KEPT
        run(range(len(want)))
    finally:
        sys.setswitchinterval(interval)
    assert sampler.table_builds == len(built) > len(want)
    assert len(sampler._tables) == sampler.TABLES_KEPT


def test_sharded_sampler_keeps_the_loop():
    """The edge-sharded sampler all-reduces through gloo in every forward,
    which a CUDA graph cannot capture: its trajectories stay the loop; the
    dense sampler and its subclasses (the screening driver's) are
    graphed."""
    from ml_conformer_generator_tpu_torch.parallel.screening import \
        _RowSampler

    assert ShardedEDMSampler._graphed is False
    assert EDMSampler._graphed is True and _RowSampler._graphed is True


# -- FIRE ---------------------------------------------------------------------


def _fire_graphed(x0, ff, n_steps):
    """What ``relax``'s graph computes, on the CPU: ``n_steps`` calls of
    the captured step on ``fire_buffers``'s tensors, as ``n_steps``
    replays; (x, history)."""
    buffers = tff.fire_buffers(x0, ff, n_steps)
    for _ in range(n_steps):
        tff.fire_graph_step(**buffers)
    return buffers["x"], buffers["history"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_fire_graphed_form_is_the_loop(dtype):
    """The step a graph captures, run on its buffers as many times as the
    replays (the state updated in place, each branch written into its row
    of a (steps, B) tensor), equals ``relax``'s loop bit for bit:
    coordinates and every step's uphill branch; the step count ends at the
    number of steps."""
    _, ff, x0 = _batch()
    fft = tff.to_device(ff, "cpu", dtype)
    x0 = torch.tensor(x0, dtype=dtype)
    log = []
    want = tff.relax(x0, fft, n_steps=200, uphill_log=log)
    got, history = _fire_graphed(x0, fft, 200)
    assert torch.equal(got, want)
    buffers = tff.fire_buffers(x0.clone(), fft, 3)
    for _ in range(3):
        tff.fire_graph_step(**buffers)
    assert buffers["step"].tolist() == [3]
    assert history.shape == (200, x0.shape[0]) and history.dtype == torch.bool
    assert torch.equal(history, torch.stack(log))
    assert history.any()


def test_fire_graphed_form_matches_jax_f64(x64):
    """Float64: the captured form against JAX's jitted relaxation, at the
    bar of ``tests/test_torch_forcefield.py``."""
    _, ff, x0 = _batch()
    jb = jff.build_ff_batch(_molecules(JMolecule), ff.excl.shape[1])
    x_j = np.asarray(jff.relax(jnp.asarray(x0), jb, n_steps=200))
    x_t, _ = _fire_graphed(torch.tensor(x0), tff.to_device(
        ff, "cpu", torch.float64), 200)
    assert np.abs(x_t.numpy() - x0).max() > 1e-3
    np.testing.assert_allclose(x_t.numpy(), x_j, rtol=1e-6, atol=1e-6)


def test_fixed_order_gather_backward_is_the_scatter_add():
    """The card's gradient of a coordinate gather (a masked sum over the
    gathered rows, in a fixed order) equals autograd's scatter-add to
    rounding; the CPU keeps the scatter-add itself."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((3, 10, 3)), requires_grad=True)
    idx = torch.tensor(rng.integers(0, 10, (3, 17)))
    g = torch.tensor(rng.standard_normal((3, 17, 3)))
    (want,) = torch.autograd.grad(
        torch.gather(x, 1, idx[..., None].expand(-1, -1, 3)), x, g)
    (cpu,) = torch.autograd.grad(tff._take(x, idx), x, g)
    assert torch.equal(cpu, want)
    fixed = tff._fixed_order_gather_grad(idx, g, 10)
    torch.testing.assert_close(fixed, want, rtol=1e-12, atol=1e-12)


# -- the capture helper and the launch accounting ------------------------------


def test_capture_raises_on_cpu_tensors():
    """A CUDA graph takes CUDA tensors; nothing falls back to eager."""
    with pytest.raises(ValueError, match="CUDA"):
        capture(lambda x: x * 2, {"x": torch.ones(3)})


def test_graph_cache_keeps_the_newest_and_recaptures_on_a_new_token():
    made = []

    def make(tag):
        return lambda: made.append(tag) or tag

    cache = GraphCache(2)
    assert cache.get("a", 0, make("a0")) == "a0"
    assert cache.get("a", 0, make("a1")) == "a0"        # kept
    assert cache.get("a", 1, make("a2")) == "a2"        # new weights
    cache.get("b", 0, make("b0"))
    cache.get("c", 0, make("c0"))                       # "a" goes
    assert len(cache) == 2
    assert cache.get("a", 1, make("a3")) == "a3"
    assert made == ["a0", "a2", "b0", "c0", "a3"]
    assert cache.captures == len(made)


def test_the_backward_pack_keeps_the_forward_pack():
    """A graph reads a weight's forward pack by address: adding the
    backward's pack to the weight's cache entry keeps that tensor, and only
    a new version of the weight makes another."""
    w1 = torch.tensor(np.random.default_rng(0).standard_normal((64, 64)),
                      dtype=torch.float32)
    forward = gk.packed_w1(w1)
    again, backward = gk.packed_w1(w1, backward=True)
    assert again is forward
    assert torch.equal(backward, gk.pack_w1(w1.t()))
    assert gk.packed_w1(w1) is forward
    with torch.no_grad():
        w1.add_(1.0)
    assert gk.packed_w1(w1) is not forward


def test_replays_credit_the_launches_their_capture_recorded():
    """A replay launches no Python wrapper: it credits what its capture
    recorded, and the thread's tally of captured launches is kept apart
    from LAUNCHES."""
    gk.reset_launch_counts()
    tally = gk.captured_launches()
    assert tally is gk.captured_launches()
    gk.credit_launches({"gcl": 18, "coord": 9})
    gk.credit_launches({"gcl": 18, "coord": 9})
    assert gk.LAUNCHES == {"gcl": 36, "coord": 18, "gcl_bwd": 0,
                           "coord_bwd": 0}
    gk.reset_launch_counts()
