"""E(3)-equivariant diffusion (EDM) reverse sampler, PyTorch twin of
``ml_conformer_generator_tpu/diffusion/edm.py``: plain generation, fragment
inpainting and the merge of fixed and generated fragments.

Execution, the twin of the JAX sampler's one ``lax.scan`` under ``jit``:
each trajectory is one function (:meth:`EDMSampler.trajectory`) of a table
of its host scalars and a source of noise. The table depends only on the
schedule (gamma, the latent's type, the blend power and the level), so a
sampler builds it once per schedule and keeps it (:meth:`EDMSampler.table`).
On the card the whole trajectory, every reverse step, resample and fragment
blend and the decode, is one captured CUDA graph (``utils/cuda_graph.py``),
replayed once a request: the graph reads the scalars from the kept device
table and the noise from a buffer that the request's draws fill first. On
CPU tensors the same function runs as a Python loop over the table's
floats, drawing as it goes (the plain version, which the CPU tests hold the
graph's form against).
All randomness comes from an explicit ``torch.Generator`` through
:meth:`EDMSampler.sample_noise`, in the JAX sampler's call order (each
trajectory's docstring gives it), in the loop and before a replay alike, so
the draws and the generator's state after a request are the loop's; a test
replaces the method on an instance to replay another sampler's draws.

Conventions: latent z (B, N, 3 + in_node_nf) = [positions | atom features];
node_mask (B, N, 1); edge_mask (B, N, N, 1); gamma: (T+1,) CPU tensor from
``schedule.gamma_schedule``. The per-step schedule scalars are computed in
gamma's dtype on the host (:func:`step_scalars`, :func:`decode_scalars`,
gathered by :func:`scalar_table`). A CUDA division of a float32 tensor by a
host float multiplies by the divisor's float32 reciprocal, while a division
by a device tensor divides; so the table holds 1 / alpha_{t|s} and 1 /
alpha_0 rounded as that reciprocal (:func:`reciprocal`), and the step and
the decode multiply by them (:func:`reverse_step`, :func:`decode_xh`): a
Python float and its device-table copy then give the same bits. The
exported sampler (``export.py``) calls the same step with 0-d CPU tensors
read from a table of the same values.

Parity note: the reference's decode step (``sample_p_xh_given_z0`` :261-285)
takes atom-type features from ``z0[:, :, n_dims:-1]`` — dropping the *last*
atom-class channel before the argmax, so class 7 (Br) is never emitted. The
port keeps this.
"""

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import DiffusionConfig
from ..models.egnn import remove_mean_with_mask
from ..utils.cuda_graph import GraphCache, capture
from ..utils.metrics import span, spanned

# ---------------------------------------------------------------------------
# Noise sampling
# ---------------------------------------------------------------------------


def _randn(generator: Optional[torch.Generator], shape, like: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=dtype)


def sample_center_gravity_zero_gaussian_with_mask(generator, shape, node_mask,
                                                  dtype=torch.float32):
    """Masked gaussian positions projected to zero centre of mass (:56-67)."""
    x = _randn(generator, shape, node_mask, dtype) * node_mask
    return remove_mean_with_mask(x, node_mask)


def sample_gaussian_with_mask(generator, shape, node_mask, dtype=torch.float32):
    return _randn(generator, shape, node_mask, dtype) * node_mask


def sample_combined_position_feature_noise(generator, n_samples: int,
                                           n_nodes: int, node_mask,
                                           n_dims: int, in_node_nf: int,
                                           dtype=torch.float32):
    """Zero-CoM gaussian for positions, plain gaussian for features (:341-363)."""
    z_x = sample_center_gravity_zero_gaussian_with_mask(
        generator, (n_samples, n_nodes, n_dims), node_mask, dtype)
    z_h = sample_gaussian_with_mask(
        generator, (n_samples, n_nodes, in_node_nf), node_mask, dtype)
    return torch.cat([z_x, z_h], dim=-1)


# ---------------------------------------------------------------------------
# Closed-form schedule quantities
# ---------------------------------------------------------------------------


def sigma_of(gamma: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sigmoid(gamma))


def alpha_of(gamma: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sigmoid(-gamma))


def sigma_and_alpha_t_given_s(gamma_t: torch.Tensor, gamma_s: torch.Tensor):
    """Posterior transition scales (reference :224-247)."""
    sigma2_t_given_s = 1 - torch.exp(F.softplus(gamma_s) - F.softplus(gamma_t))
    log_alpha2_t = F.logsigmoid(-gamma_t)
    log_alpha2_s = F.logsigmoid(-gamma_s)
    alpha_t_given_s = torch.exp(0.5 * (log_alpha2_t - log_alpha2_s))
    sigma_t_given_s = torch.sqrt(sigma2_t_given_s)
    return sigma2_t_given_s, sigma_t_given_s, alpha_t_given_s


def mask_noise(raw: torch.Tensor, node_mask: torch.Tensor, n_dims: int
               ) -> torch.Tensor:
    """Standard normals (B, N, n_dims + features) made into the sampler's
    noise as :func:`sample_combined_position_feature_noise` makes its
    draws: masked, the positions projected to zero centre of mass. The
    exported sampler takes its noise raw and applies this."""
    x = remove_mean_with_mask(raw[..., :n_dims] * node_mask, node_mask)
    return torch.cat([x, raw[..., n_dims:] * node_mask], dim=-1)


def reciprocal(a: float, dtype: torch.dtype) -> float:
    """1 / a, rounded as the device arithmetic of ``dtype`` rounds it: a
    CUDA division of a float32 tensor by a host scalar multiplies by this
    float32 reciprocal, so the sampler multiplies by it on every device."""
    return (torch.ones((), dtype=dtype) / torch.tensor(a, dtype=dtype)).item()


def step_scalars(gamma: torch.Tensor, s_idx: int, T: int, dtype: torch.dtype
                 ) -> Tuple[float, float, float, float]:
    """The schedule scalars of reverse step s (t = s + 1), computed in
    gamma's dtype (:295-329): (t / T, 1 / alpha_{t|s} as :func:`reciprocal`
    gives it for a latent of ``dtype``, sigma2_{t|s} / alpha_{t|s} /
    sigma_t, sigma_{t|s} sigma_s / sigma_t)."""
    gamma_s = gamma[s_idx]
    gamma_t = gamma[s_idx + 1]
    sigma2_tgs, sigma_tgs, alpha_tgs = sigma_and_alpha_t_given_s(gamma_t,
                                                                 gamma_s)
    sigma_s = sigma_of(gamma_s)
    sigma_t = sigma_of(gamma_t)
    # normalised time in gamma's dtype, as the JAX sampler computes it
    t_norm = torch.tensor(s_idx + 1, dtype=gamma.dtype) / T
    return (t_norm.item(), reciprocal(alpha_tgs.item(), dtype),
            (sigma2_tgs / alpha_tgs / sigma_t).item(),
            (sigma_tgs * sigma_s / sigma_t).item())


def decode_scalars(gamma: torch.Tensor, dtype: torch.dtype
                   ) -> Tuple[float, float, float]:
    """(sigma_x, sigma_0, 1 / alpha_0) of the decode (:261-285), the
    reciprocal as :func:`reciprocal` gives it for a latent of ``dtype``."""
    gamma_0 = gamma[0]
    return (torch.exp(0.5 * gamma_0).item(),   # snr(-0.5 * gamma_0)
            sigma_of(gamma_0).item(),
            reciprocal(alpha_of(gamma_0).item(), dtype))


def time_array(t, B: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The denoiser's (B,) time input from a Python float or a 0-d tensor."""
    if isinstance(t, torch.Tensor):
        return t.to(device=device, dtype=dtype).expand(B)
    return torch.full((B,), t, dtype=dtype, device=device)


def reverse_step(z, eps_t, noise, inv_alpha_tgs, coef, sigma, node_mask,
                 n_dims: int) -> torch.Tensor:
    """z_t -> z_s from the denoiser's output eps_t and the step's (masked)
    noise, CoM-projected; scalars as :func:`step_scalars` gives them."""
    mu = z * inv_alpha_tgs - coef * eps_t
    zs = mu + sigma * noise
    x = remove_mean_with_mask(zs[..., :n_dims], node_mask)
    return torch.cat([x, zs[..., n_dims:]], dim=-1)


def decode_xh(z0, net_out, noise, sigma_x, sigma_0, inv_alpha_0, node_mask,
              diff_cfg: DiffusionConfig):
    """(x, h) from the last latent, the denoiser's output at t = 0 and the
    decode's noise; scalars as :func:`decode_scalars` gives them."""
    nd = diff_cfg.n_dims
    mu_x = (z0 - sigma_0 * net_out) * inv_alpha_0
    xh = mu_x + sigma_x * noise
    x = xh[..., :nd] * diff_cfg.norm_values[0]
    # Parity: features come from z0 with the LAST class channel dropped.
    h_cat = z0[..., nd:-1] * diff_cfg.norm_values[1] * node_mask
    labels = torch.argmax(h_cat, dim=-1)
    h = F.one_hot(labels, diff_cfg.in_node_nf).to(z0.dtype) * node_mask
    return x, h


def align_fragment_com_to_generated(z_known_noised, z_generated, fixed_mask):
    """Shift the fixed fragment so its CoM matches the generated one (:79-105)."""
    coords_known = z_known_noised[..., :3]
    coords_gen = z_generated[..., :3]
    denom = torch.sum(fixed_mask, dim=1, keepdim=True)
    com_gen = torch.sum(coords_gen * fixed_mask, dim=1, keepdim=True) / denom
    com_known = (torch.sum(coords_known * fixed_mask, dim=1, keepdim=True)
                 / denom)
    shift = com_gen - com_known
    coords_shifted = coords_known + shift * fixed_mask
    return torch.cat([coords_shifted, z_known_noised[..., 3:]], dim=-1)


def _blend(s_idx: int, T: int, blend_power: int, dtype: torch.dtype):
    """Fragment weight (1 - s/T)^p at step s and its complement, computed in
    gamma's dtype as the JAX sampler does."""
    s_norm = torch.tensor(s_idx, dtype=dtype) / T
    blend = (1.0 - s_norm) ** blend_power
    return blend.item(), (1 - blend).item()


#: Columns of a trajectory's scalar table (:func:`scalar_table`). Row s < T,
#: reverse step s: its time, 1 / alpha_{t|s}, the eps coefficient and the
#: noise scale (:func:`step_scalars`); alpha_s and sigma_s, which diffuse the
#: known latent to step s; the fragment's blend weight and its complement.
#: Row T, the decode: sigma_x, sigma_0 and 1 / alpha_0 (:func:`decode_scalars`),
#: and in ALPHA_S, SIGMA_S the scales that diffuse the known latent to
#: merge's first level.
T_NORM, INV_ALPHA, COEF, SIGMA, ALPHA_S, SIGMA_S, BLEND, KEEP = range(8)
SIGMA_X, SIGMA_0, INV_ALPHA_0 = range(3)


@spanned("mlcg.sample.table")
def scalar_table(gamma: torch.Tensor, dtype: torch.dtype,
                 blend_power: int = 3, diffusion_level: int = 0):
    """Every host scalar of a trajectory as (T + 1) rows of 8 Python floats
    (columns as named above), computed in gamma's dtype; reciprocals for a
    latent of ``dtype``. The loop reads it as it is; the captured graph
    reads it from a device table of ``dtype``, where each value is what the
    loop's float becomes in the device arithmetic."""
    T = gamma.shape[0] - 1
    rows = []
    for s in range(T):
        rows.append([*step_scalars(gamma, s, T, dtype),
                     alpha_of(gamma[s]).item(), sigma_of(gamma[s]).item(),
                     *_blend(s, T, blend_power, gamma.dtype)])
    # JAX's gather clamps an index past the table's end: gamma[T] then
    # stands for any diffusion_level > T.
    level = gamma[min(diffusion_level, T)]
    rows.append([*decode_scalars(gamma, dtype), 0.0,
                 alpha_of(level).item(), sigma_of(level).item(), 0.0, 0.0])
    return rows


def n_draws(trajectory: str, T: int, resample_steps: int,
            diffusion_level: int = 0) -> int:
    """How many noise draws a trajectory makes (resample_steps as the
    trajectory takes it: inpaint and merge run max(r, 1))."""
    if trajectory == "generate":
        return 1 + T * (resample_steps + 1) + 1
    r = max(resample_steps, 1)
    if trajectory == "inpaint":
        return 1 + T * (2 * r + 1) + 1
    return 1 + (min(diffusion_level, T - 1) + 1) * 2 * r + 1


# ---------------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------------


class EDMSampler:
    """EDM reverse sampler bound to a denoiser module (``dynamics(t, z,
    node_mask, edge_mask, context)`` returns the eps prediction).

    ``gamma`` is passed at call time as a (T+1,) CPU tensor.

    Each trajectory (:meth:`generate`, :meth:`inpaint`,
    :meth:`merge_fragments`) is one function, :meth:`trajectory`, of a
    scalar table and a source of noise. Tables are built once per schedule
    and kept (:meth:`table`). On CPU tensors a trajectory runs as a loop
    over the table's Python floats, drawing as it goes. On CUDA tensors the
    request's draws are made first, in the same order, into one tensor, and
    the whole trajectory, decode included, is one captured CUDA graph
    (``utils/cuda_graph.py``) that reads the table from the device; graphs
    are kept per trajectory, static options and shapes, and captured again
    when the denoiser's weights change storage or version.
    """

    #: Whether CUDA tensors run through captured graphs. A subclass whose
    #: denoiser cannot be captured sets it False; it is not a switch for
    #: callers (the eager loop on the card exists for comparison only).
    _graphed = True
    #: Captured graphs kept per sampler. On the H100 a graph holds 24-26 MiB
    #: at 64 samples and 46-150 MiB at 200, the most a request of the app
    #: takes; 16 generate graphs at 200 samples hold 1.6 GiB (PERF.md).
    GRAPHS_KEPT = 16
    #: Scalar tables kept per sampler (:meth:`table`), least recently used
    #: first out: one a schedule, blend power and level asked for. A T =
    #: 1000 table is about 0.3 MB of Python floats and 32 KB on the card.
    TABLES_KEPT = 16

    def __init__(self, dynamics, diff_cfg: DiffusionConfig):
        self.dynamics = dynamics
        self.diff_cfg = diff_cfg
        self._graphs = GraphCache(self.GRAPHS_KEPT)
        #: Scalar tables built by :meth:`table` since the sampler was made:
        #: one per schedule it was asked for, unless evicted and asked again.
        self.table_builds = 0
        self._tables: "OrderedDict[tuple, dict]" = OrderedDict()
        self._tables_lock = threading.Lock()

    def sample_noise(self, generator, n_samples: int, n_nodes: int,
                     node_mask: torch.Tensor, dtype: torch.dtype):
        """The one source of the sampler's noise (replaceable in tests)."""
        return sample_combined_position_feature_noise(
            generator, n_samples, n_nodes, node_mask, self.diff_cfg.n_dims,
            self.diff_cfg.in_node_nf, dtype)

    # -- single-step math ----------------------------------------------------

    def phi(self, z, t, node_mask, edge_mask, context):
        return self.dynamics(t, z, node_mask, edge_mask, context)

    def _step(self, z, row, noise, node_mask, edge_mask, context, t_dtype):
        """One reverse step z_t -> z_s from the table row of step s."""
        B = z.shape[0]
        eps_t = self.phi(z, time_array(row[T_NORM], B, t_dtype, z.device),
                         node_mask, edge_mask, context)
        return reverse_step(z, eps_t, noise(), row[INV_ALPHA], row[COEF],
                            row[SIGMA], node_mask, self.diff_cfg.n_dims)

    def _decode(self, z0, row, noise, node_mask, edge_mask, context,
                t_dtype):
        """p(x, h | z0) from the table's decode row."""
        t_arr = torch.zeros((z0.shape[0],), dtype=t_dtype, device=z0.device)
        net_out = self.phi(z0, t_arr, node_mask, edge_mask, context)
        return decode_xh(z0, net_out, noise(), row[SIGMA_X], row[SIGMA_0],
                         row[INV_ALPHA_0], node_mask, self.diff_cfg)

    @staticmethod
    def _diffuse(z_known, row, noise):
        """q(z_s | z_known) = alpha_s z_known + sigma_s eps, the scales from
        the table row."""
        return row[ALPHA_S] * z_known + row[SIGMA_S] * noise()

    def sample_p_zs_given_zt(self, generator, z, s_idx: int, gamma,
                             node_mask, edge_mask, context) -> torch.Tensor:
        """One reverse step z_t -> z_s with fresh noise; CoM-projected (:295-339)."""
        row = step_scalars(gamma, s_idx, self.diff_cfg.timesteps, z.dtype)
        return self._step(z, row, self._drawer(generator, node_mask, z.dtype),
                          node_mask, edge_mask, context, gamma.dtype)

    def decode_z0(self, generator, z0, gamma, node_mask, edge_mask, context):
        """Sample p(x, h | z0): final denoise + argmax one-hot decode (:261-285)."""
        return self._decode(z0, decode_scalars(gamma, z0.dtype),
                            self._drawer(generator, node_mask, z0.dtype),
                            node_mask, edge_mask, context, gamma.dtype)

    def forward_diffuse(self, generator, z_known, s_idx: int, gamma,
                        node_mask):
        """q(z_s | z_known): alpha_s z_known + sigma_s eps, in z_known's type."""
        gamma_s = gamma[s_idx]
        B, N, _ = z_known.shape
        eps = self.sample_noise(generator, B, N, node_mask, z_known.dtype)
        return (alpha_of(gamma_s).item() * z_known
                + sigma_of(gamma_s).item() * eps)

    def _drawer(self, generator, node_mask, dtype):
        B, N, _ = node_mask.shape
        return lambda: self.sample_noise(generator, B, N, node_mask, dtype)

    # -- full trajectories ---------------------------------------------------

    def trajectory(self, trajectory: str, table, noise, node_mask, edge_mask,
                   context, z_known=None, fixed_mask=None,
                   resample_steps: int = 0, diffusion_level: int = 0, *,
                   t_dtype: torch.dtype, steps: Optional[int] = None):
        """A whole trajectory as one function of its scalar ``table``
        (:func:`scalar_table`'s rows: Python floats, or a (T + 1, 8) tensor
        whose rows the arithmetic reads as 0-d tensors) and ``noise``, a
        callable returning the next draw. ``resample_steps`` as the
        trajectory takes it (inpaint and merge: at least 1); ``t_dtype``:
        the denoiser's time type (gamma's); ``steps``: run only the first
        ``steps`` reverse steps (a warm-up). Returns (x, h)."""
        T = self.diff_cfg.timesteps
        args = (node_mask, edge_mask, context, t_dtype)
        if trajectory == "merge":
            z = self._diffuse(z_known, table[T], noise)
            s_values = range(min(diffusion_level, T - 1), -1, -1)
        else:
            z = noise()
            s_values = range(T - 1, -1, -1)
        for s_idx in list(s_values)[:steps]:
            row = table[s_idx]
            if trajectory == "generate":
                for _ in range(resample_steps + 1):
                    z = self._step(z, row, noise, *args)
                continue
            for _ in range(resample_steps):
                z = self._step(z, row, noise, *args)
                # noise the known latent to step s, move it onto the
                # generated fragment's CoM and blend it in on the fixed nodes
                known = align_fragment_com_to_generated(
                    self._diffuse(z_known, row, noise), z, fixed_mask)
                z = (row[BLEND] * known * fixed_mask
                     + row[KEEP] * z * fixed_mask
                     + z * (1 - fixed_mask))
            if trajectory == "inpaint":
                z = self._step(z, row, noise, *args)
        return self._decode(z, table[T], noise, *args)

    def _run(self, trajectory: str, generator, gamma, node_mask, edge_mask,
             context, z_known=None, fixed_mask=None, resample_steps: int = 0,
             blend_power: int = 3, diffusion_level: int = 0,
             dtype: torch.dtype = torch.float32):
        """A trajectory on ``node_mask``'s device: the loop on the CPU (or
        where ``_graphed`` is off), a captured graph on the card. Spans:
        the host prelude (the table's lookup, its build only on a
        schedule's first request; on the card the draws and the graph's
        lookup), then the trajectory (the loop, or the replay's enqueue)."""
        with span("mlcg.sample.prelude"):
            if trajectory != "generate":
                resample_steps = max(resample_steps, 1)
                z_known = z_known.to(device=node_mask.device, dtype=dtype)
                fixed_mask = fixed_mask.to(node_mask.device)
            static = dict(trajectory=trajectory,
                          resample_steps=resample_steps,
                          diffusion_level=diffusion_level, t_dtype=gamma.dtype)
            tensors = dict(node_mask=node_mask, edge_mask=edge_mask,
                           context=context)
            if trajectory != "generate":
                tensors.update(z_known=z_known, fixed_mask=fixed_mask)
            if node_mask.device.type != "cuda" or not self._graphed:
                run = functools.partial(
                    self.trajectory,
                    table=self.table(gamma, dtype, blend_power,
                                     diffusion_level),
                    noise=self._drawer(generator, node_mask, dtype),
                    **static, **tensors)
            else:
                inputs = self.buffers(generator, gamma,
                                      blend_power=blend_power, dtype=dtype,
                                      **static, **tensors)
                key = (tuple(sorted(static.items())), self.diff_cfg.timesteps,
                       tuple((k, tuple(v.shape), v.dtype)
                             for k, v in inputs.items()))
                replay = functools.partial(self.from_buffers, static)
                graph = self._graphs.get(
                    key, self._weights_token(), lambda: capture(
                        replay, inputs,
                        warmup=functools.partial(replay, steps=1)))
                run = functools.partial(graph, **inputs)
        with span("mlcg.sample.trajectory"):
            return run()

    def table(self, gamma: torch.Tensor, dtype: torch.dtype,
              blend_power: int = 3, diffusion_level: int = 0,
              device: Optional[torch.device] = None):
        """:func:`scalar_table`'s rows, or with ``device`` their (T + 1, 8)
        tensor of ``dtype`` there (made as ``torch.tensor(rows,
        dtype=dtype)``, so each value has the bits the per-request copy
        had), built on this sampler's first request of a schedule and kept.
        The key is all the table depends on: gamma's contents (dtype, shape
        and bytes, so a gamma replaced or edited in place builds anew),
        ``dtype``, ``blend_power`` and the level the table reads,
        ``min(diffusion_level, T)``. What it returns is shared: callers
        only read it."""
        T = gamma.shape[0] - 1
        g = gamma.cpu().contiguous()
        key = (g.dtype, tuple(g.shape), g.view(torch.uint8).numpy().tobytes(),
               dtype, blend_power, min(diffusion_level, T))
        with self._tables_lock:
            entry = self._tables.get(key)
            if entry is None:
                entry = self._tables[key] = {None: scalar_table(
                    gamma, dtype, blend_power, diffusion_level)}
                self.table_builds += 1
                while len(self._tables) > self.TABLES_KEPT:
                    self._tables.popitem(last=False)
            self._tables.move_to_end(key)
        if device is not None and device not in entry:
            # outside the lock: a copy to the card waits for the caller's
            # stream
            entry.setdefault(device, torch.tensor(entry[None], dtype=dtype,
                                                  device=device))
        return entry[device]

    def buffers(self, generator, gamma, *, trajectory, resample_steps,
                diffusion_level, t_dtype, blend_power, dtype, **tensors):
        """What a captured trajectory reads besides ``tensors`` (the masks,
        context and known fragment): its scalar table as a (T + 1, 8)
        tensor of the latent's ``dtype`` on their device, the one
        :meth:`table` keeps (nothing writes into it: :func:`capture` clones
        its inputs and a replay copies from them), and the request's noise,
        every draw made now through :meth:`sample_noise` in the loop's
        order, one tensor. The generator ends where the loop leaves it."""
        node_mask = tensors["node_mask"]
        draw = self._drawer(generator, node_mask, dtype)
        count = n_draws(trajectory, self.diff_cfg.timesteps, resample_steps,
                        diffusion_level)
        table = self.table(gamma, dtype, blend_power, diffusion_level,
                           node_mask.device)
        if table.is_cuda:
            # threads on other streams share the table: its memory is
            # reused only after this stream's reads of it
            table.record_stream(torch.cuda.current_stream(table.device))
        with span("mlcg.sample.draws"):
            draws = torch.stack([draw() for _ in range(count)])
        return dict(table=table, draws=draws, **tensors)

    def from_buffers(self, static, steps=None, *, table, draws, **tensors):
        """The trajectory a graph captures: :meth:`trajectory` with the
        scalars read from ``table`` and the noise from ``draws`` (as
        :meth:`buffers` makes them); ``static``: the trajectory's static
        options; ``steps`` as :meth:`trajectory` takes it."""
        it = iter(draws)
        return self.trajectory(table=table, noise=lambda: next(it),
                               steps=steps, **static, **tensors)

    def _weights_token(self):
        """Where and at which version the denoiser's tensors are: a graph
        reads them by address, so another storage or an in-place update
        (loading weights) means another capture."""
        return tuple((t.data_ptr(), t._version)
                     for t in (*self.dynamics.parameters(),
                               *self.dynamics.buffers()))

    @torch.no_grad()
    def generate(self, generator, gamma, node_mask, edge_mask, context,
                 resample_steps: int = 0, dtype: torch.dtype = torch.float32):
        """Plain ancestral sampling (reference ``forward`` :365-421).

        Runs the denoiser ``T * (resample_steps + 1) + 1`` times. ``dtype``
        is the latent's type (float32 in production, float64 in parity
        tests). Noise draws: the initial latent; one a step; the decode.
        """
        return self._run("generate", generator, gamma, node_mask, edge_mask,
                         context, resample_steps=resample_steps, dtype=dtype)

    @torch.no_grad()
    def inpaint(self, generator, gamma, node_mask, edge_mask, context,
                z_known, fixed_mask, resample_steps: int = 1,
                blend_power: int = 3, dtype: torch.dtype = torch.float32):
        """Fragment-fixed generation with soft polynomial blending (:423-513).

        Noise draws: the initial latent; per step and per resample, the
        step's noise then the forward diffusion's; the extra step's noise;
        the decode. Runs the denoiser ``T * (max(resample_steps, 1) + 1) +
        1`` times.
        """
        return self._run("inpaint", generator, gamma, node_mask, edge_mask,
                         context, z_known, fixed_mask,
                         resample_steps=resample_steps,
                         blend_power=blend_power, dtype=dtype)

    @torch.no_grad()
    def merge_fragments(self, generator, gamma, node_mask, edge_mask,
                        fixed_mask, context, z_known,
                        diffusion_level: int = 50, resample_steps: int = 1,
                        blend_power: int = 3,
                        dtype: torch.dtype = torch.float32):
        """Merge fixed + generated fragments by partial re-diffusion (:515-607).

        ``z_known`` is diffused to ``diffusion_level`` and denoised from
        step ``min(diffusion_level, T - 1)`` down, blending the fixed
        fragment back in at every step. Noise draws: the forward diffusion
        of ``z_known``; per step and per resample, the step's noise then the
        forward diffusion's; the decode.
        """
        return self._run("merge", generator, gamma, node_mask, edge_mask,
                         context, z_known, fixed_mask,
                         resample_steps=resample_steps,
                         blend_power=blend_power,
                         diffusion_level=diffusion_level, dtype=dtype)
