"""Batched geometry relaxation in PyTorch (twin of
``ml_conformer_generator_tpu/chem/forcefield.py``).

The reference runs constrained MMFF94 minimisation per molecule on the CPU
through RDKit (``utils/standardizer.py:62-80``: position constraint 0.2 A /
k=800 on every heavy atom). Here a restrained heavy-atom force field is
evaluated over the whole padded batch on the generator's device, with forces
from ``torch.autograd.grad``.

Energy terms: harmonic bond stretch toward covalent-radius lengths scaled by
bond order; cosine angle bends with hybridisation-dependent ideal angles;
2-fold torsions about double/aromatic bonds; improper terms at sp2 centres
with three neighbours; soft-core repulsion between non-bonded pairs; and
flat-bottomed harmonic position restraints (0.2 A / k=800) to the input
geometry. Minimisation: batched FIRE at a fixed iteration count. On the card
one FIRE step, its autograd forward and backward included, is a captured
CUDA graph per batch shape (``utils/cuda_graph.py``) over static buffers of
the state, replayed once a step, the counterpart of the JAX package's
jitted ``lax.scan`` (a step's capture costs milliseconds where the whole
relaxation's cost about a second, and the batch shape changes with nearly
every request: PERF.md); on CPU tensors it runs as a loop of the same
steps (:func:`fire_steps`). The card's gradient sums each atom's
contributions in a fixed order, so a relaxation gives the same bits every
time it runs.

``build_ff_batch`` (numpy topology) is a copy of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from ..utils.cuda_graph import GraphCache, capture
from ..utils.device import resolve_device
from . import periodic
from .mol import Molecule

#: Bond-length scale factors per bond order (single/double/triple/aromatic).
_ORDER_SCALE = {1: 1.0, 2: 0.87, 3: 0.78, 4: 0.92}


def _pad8(n: int) -> int:
    return max(8, ((n + 7) // 8) * 8)


@dataclasses.dataclass
class FFBatch:
    """Padded per-batch force-field topology (host-built, device-consumed)."""

    bonds: np.ndarray        # (B, MB, 2) int
    bond_r0: np.ndarray      # (B, MB)
    bond_mask: np.ndarray    # (B, MB)
    angles: np.ndarray       # (B, MA, 3) int  (i, c, j) triplets
    angle_cos0: np.ndarray   # (B, MA)
    angle_mask: np.ndarray   # (B, MA)
    torsions: np.ndarray     # (B, MT, 4) int  (i, b, c, j) about order-2/4 b-c
    torsion_mask: np.ndarray  # (B, MT)
    impropers: np.ndarray    # (B, MI, 4) int  (c, i, j, k) sp2 centres
    improper_mask: np.ndarray  # (B, MI)
    excl: np.ndarray         # (B, N, N) 1 where pair is bonded/1-3/self/padded
    contact: np.ndarray      # (B, N, N) nonbonded contact distance
    node_mask: np.ndarray    # (B, N)


def _hybridisation(mol: Molecule, neigh, orders) -> List[int]:
    """2 = sp, 3 = sp2, 4 = sp3 (by bond orders / neighbour count).

    Hypervalent centres are NOT inferred from multiple bonds: S and P keep
    pyramidal/tetrahedral geometry (sulfoxides, sulfones, phosphates), and
    any >=4-coordinate centre is tetrahedral regardless of its bond orders.
    """
    hyb = []
    for a in range(mol.num_atoms):
        ns = neigh[a]
        os_ = [orders[(a, n)] for n in ns]
        z = int(mol.atomic_nums[a])
        if len(ns) >= 4 or z in (15, 16):
            hyb.append(4)
        elif (3 in os_ or os_.count(2) >= 2) and len(ns) <= 2:
            hyb.append(2)
        elif 2 in os_ or 4 in os_:
            hyb.append(3)
        else:
            hyb.append(4)
    return hyb


_IDEAL_COS = {2: -1.0, 3: -0.5, 4: -1.0 / 3.0}  # cos(180), cos(120), cos(109.47)


def build_ff_batch(mols: List[Molecule], n_pad: int) -> FFBatch:
    """Build the padded topology arrays for a list of (kekulised) molecules."""
    B = len(mols)
    all_bonds, all_angles, all_tors, all_imps = [], [], [], []
    for mol in mols:
        radii = [periodic.covalent_radius(int(z)) for z in mol.atomic_nums]
        neigh = mol.neighbors()
        orders = {}
        for i, j, o in mol.bonds:
            orders[(i, j)] = o
            orders[(j, i)] = o
        bonded = set(orders)

        bonds = [(i, j, (radii[i] + radii[j]) * _ORDER_SCALE.get(o, 1.0))
                 for i, j, o in mol.bonds]

        hyb = _hybridisation(mol, neigh, orders)

        angles = []
        for c in range(mol.num_atoms):
            ns = neigh[c]
            cos0 = _IDEAL_COS[hyb[c]]
            for a_i in range(len(ns)):
                for a_j in range(a_i + 1, len(ns)):
                    i, j = ns[a_i], ns[a_j]
                    if (i, j) in bonded:
                        continue  # 3-ring: the bond itself sets the angle
                    angles.append((i, c, j, cos0))

        torsions = []
        for b, c, o in mol.bonds:
            if o not in (2, 4):
                continue
            for i in neigh[b]:
                if i == c:
                    continue
                for j in neigh[c]:
                    if j == b or j == i:
                        continue
                    torsions.append((i, b, c, j))

        imps = []
        for c in range(mol.num_atoms):
            if hyb[c] == 3 and len(neigh[c]) == 3:
                i, j, k = neigh[c]
                imps.append((c, i, j, k))

        all_bonds.append(bonds)
        all_angles.append(angles)
        all_tors.append(torsions)
        all_imps.append(imps)

    # Pad term counts to multiples of 8: bounds the number of distinct shapes
    # across batches whose exact topology sizes differ only slightly.
    MB = _pad8(max((len(b) for b in all_bonds), default=1))
    MA = _pad8(max((len(a) for a in all_angles), default=1))
    MT = _pad8(max((len(t) for t in all_tors), default=1))
    MI = _pad8(max((len(m) for m in all_imps), default=1))

    bonds = np.zeros((B, MB, 2), dtype=np.int32)
    bond_r0 = np.zeros((B, MB), dtype=np.float32)
    bond_mask = np.zeros((B, MB), dtype=np.float32)
    angles = np.zeros((B, MA, 3), dtype=np.int32)
    angle_cos0 = np.zeros((B, MA), dtype=np.float32)
    angle_mask = np.zeros((B, MA), dtype=np.float32)
    torsions = np.zeros((B, MT, 4), dtype=np.int32)
    torsion_mask = np.zeros((B, MT), dtype=np.float32)
    impropers = np.zeros((B, MI, 4), dtype=np.int32)
    improper_mask = np.zeros((B, MI), dtype=np.float32)
    excl = np.zeros((B, n_pad, n_pad), dtype=np.float32)
    contact = np.zeros((B, n_pad, n_pad), dtype=np.float32)
    node_mask = np.zeros((B, n_pad), dtype=np.float32)

    for b, mol in enumerate(mols):
        n = mol.num_atoms
        node_mask[b, :n] = 1.0
        for k, (i, j, r0) in enumerate(all_bonds[b]):
            bonds[b, k] = (i, j)
            bond_r0[b, k] = r0
            bond_mask[b, k] = 1.0
            excl[b, i, j] = excl[b, j, i] = 1.0
        for k, (i, c, j, cos0) in enumerate(all_angles[b]):
            angles[b, k] = (i, c, j)
            angle_cos0[b, k] = cos0
            angle_mask[b, k] = 1.0
            excl[b, i, j] = excl[b, j, i] = 1.0
        for k, quad in enumerate(all_tors[b]):
            torsions[b, k] = quad
            torsion_mask[b, k] = 1.0
        for k, quad in enumerate(all_imps[b]):
            impropers[b, k] = quad
            improper_mask[b, k] = 1.0
        excl[b] += np.eye(n_pad, dtype=np.float32)
        pad_mask = node_mask[b][:, None] * node_mask[b][None, :]
        excl[b] = np.clip(excl[b] + (1 - pad_mask), 0, 1)
        radii = np.full(n_pad, 1.5, dtype=np.float32)
        for a in range(n):
            radii[a] = periodic.covalent_radius(int(mol.atomic_nums[a]))
        contact[b] = 0.9 * (radii[:, None] + radii[None, :])

    return FFBatch(bonds, bond_r0, bond_mask, angles, angle_cos0, angle_mask,
                   torsions, torsion_mask, impropers, improper_mask,
                   excl, contact, node_mask)


def to_device(ff: FFBatch, device, dtype=torch.float32) -> FFBatch:
    """The topology as tensors on ``device``: indices int64, the rest
    ``dtype``."""
    out = {}
    for f in dataclasses.fields(FFBatch):
        a = getattr(ff, f.name)
        t = torch.as_tensor(a, device=device)
        out[f.name] = t.long() if a.dtype.kind == "i" else t.to(dtype)
    return FFBatch(**out)


class _Take(torch.autograd.Function):
    """``torch.gather`` of coordinate rows whose backward sums each atom's
    contributions in a fixed order on the card too. Autograd's own
    backward of a gather scatter-adds with atomics on CUDA, so two
    relaxations of one batch could part in the last bits; the card's
    backward here is a masked sum over the gathered rows instead. On the
    CPU it is autograd's scatter-add (sequential, the same bits as
    before)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_atoms = x.shape[1]
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if g.is_cuda:
            return _fixed_order_gather_grad(idx, g, ctx.n_atoms), None
        out = g.new_zeros(g.shape[0], ctx.n_atoms, 3)
        return out.scatter_add_(1, idx[..., None].expand(-1, -1, 3), g), None


def _fixed_order_gather_grad(idx, g, n_atoms: int) -> torch.Tensor:
    """d/dx of gathering rows ``idx`` (B, M) of x (B, n_atoms, 3), given
    the rows' gradient g (B, M, 3): each atom's rows summed by a reduction
    over M, whose order is fixed."""
    atoms = torch.arange(n_atoms, device=g.device)
    onehot = (idx[..., None] == atoms).to(g.dtype)             # (B, M, N)
    return (onehot[..., None] * g[:, :, None, :]).sum(1)


def _take(x, idx):
    """Gather coordinates: x (B, N, 3), idx (B, M) -> (B, M, 3)."""
    return _Take.apply(x, idx)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _energy(x, x0, ff: FFBatch, k_bond=300.0, k_angle=120.0, k_tor=40.0,
            k_imp=60.0, k_rep=60.0, k_restraint=800.0, restraint_flat=0.2):
    """Total restrained energy (B,), batched over the leading axis; ``ff``
    holds tensors (see :func:`to_device`)."""
    eps = 1e-12
    # bonds
    bi = _take(x, ff.bonds[..., 0])
    bj = _take(x, ff.bonds[..., 1])
    d = torch.sqrt(torch.sum((bi - bj) ** 2, -1) + eps)
    e_bond = torch.sum(ff.bond_mask * k_bond * (d - ff.bond_r0) ** 2, dim=1)

    # cosine angle bends over (i, c, j)
    ai = _take(x, ff.angles[..., 0])
    ac = _take(x, ff.angles[..., 1])
    aj = _take(x, ff.angles[..., 2])
    u = ai - ac
    v = aj - ac
    cos = torch.sum(u * v, -1) / torch.sqrt(
        torch.sum(u * u, -1) * torch.sum(v * v, -1) + eps)
    e_angle = torch.sum(ff.angle_mask * k_angle * (cos - ff.angle_cos0) ** 2,
                        dim=1)

    # 2-fold torsions about double/aromatic bonds: E ~ sin^2(phi)
    ti = _take(x, ff.torsions[..., 0])
    tb = _take(x, ff.torsions[..., 1])
    tc = _take(x, ff.torsions[..., 2])
    tj = _take(x, ff.torsions[..., 3])
    b1 = ti - tb
    ax = tc - tb
    b2 = tj - tc
    n1 = _cross(b1, ax)
    n2 = _cross(ax, b2)
    cos_phi2 = torch.sum(n1 * n2, -1) ** 2 / (
        torch.sum(n1 * n1, -1) * torch.sum(n2 * n2, -1) + eps)
    e_tor = torch.sum(ff.torsion_mask * k_tor * (1.0 - cos_phi2), dim=1)

    # improper out-of-plane at sp2 centres: normalised triple product
    pc = _take(x, ff.impropers[..., 0])
    pi_ = _take(x, ff.impropers[..., 1])
    pj = _take(x, ff.impropers[..., 2])
    pk = _take(x, ff.impropers[..., 3])
    w1 = pi_ - pc
    w2 = pj - pc
    w3 = pk - pc
    trip = torch.sum(_cross(w1, w2) * w3, -1)
    norm = torch.sqrt(torch.sum(w1 * w1, -1) * torch.sum(w2 * w2, -1)
                      * torch.sum(w3 * w3, -1) + eps)
    e_imp = torch.sum(ff.improper_mask * k_imp * (trip / norm) ** 2, dim=1)

    # nonbonded soft repulsion
    diff = x[:, :, None, :] - x[:, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, -1) + eps)
    viol = torch.clamp(ff.contact - dist, min=0.0)
    e_rep = 0.5 * torch.sum((1.0 - ff.excl) * k_rep * viol ** 2, dim=(1, 2))

    # flat-bottom position restraints
    dr = torch.sqrt(torch.sum((x - x0) ** 2, -1) + eps)
    over = torch.clamp(dr - restraint_flat, min=0.0)
    e_res = torch.sum(ff.node_mask * k_restraint * over ** 2, dim=1)

    return e_bond + e_angle + e_tor + e_imp + e_rep + e_res


def energy_grad(x, x0, ff: FFBatch) -> torch.Tensor:
    """d(sum of energies)/dx through autograd."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(_energy(xg, x0, ff)), xg)
    return g


#: FIRE's constants (Bitzek et al.): the mixing factor's start and decay,
#: the timestep's growth and cut, and the downhill steps before growth.
_ALPHA0, _F_ALPHA, _F_INC, _F_DEC, _N_MIN = 0.1, 0.99, 1.1, 0.5, 5


def fire_state(x0: torch.Tensor, dt0: float):
    """FIRE's state at its start: (x, v, dt, alpha, n_pos), the last three
    per sample."""
    B = x0.shape[0]
    f = dict(dtype=x0.dtype, device=x0.device)
    return (x0, torch.zeros_like(x0), torch.full((B,), dt0, **f),
            torch.full((B,), _ALPHA0, **f),
            torch.zeros((B,), dtype=torch.int32, device=x0.device))


def fire_step(x, v, dt, alpha, n_pos, x0, ff: FFBatch, dt_max: float,
              max_step: float):
    """One FIRE step, as :func:`relax` documents it: the next (x, v, dt,
    alpha, n_pos) and the (B,) bool branch tensor (``P < 0``). Constant
    scalars only and no host synchronisation."""
    nm = ff.node_mask[..., None]
    f = -energy_grad(x, x0, ff) * nm
    p = torch.sum(f * v, dim=(1, 2))                            # (B,)
    vnorm = torch.sqrt(torch.sum(v * v, dim=(1, 2)) + 1e-12)
    fnorm = torch.sqrt(torch.sum(f * f, dim=(1, 2)) + 1e-12)
    v_mix = ((1 - alpha)[:, None, None] * v
             + (alpha * vnorm / fnorm)[:, None, None] * f)
    uphill = p < 0.0
    v = torch.where(uphill[:, None, None], torch.zeros_like(v_mix), v_mix)
    n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
    grow = (~uphill) & (n_pos > _N_MIN)
    dt = torch.where(grow, torch.clamp(dt * _F_INC, max=dt_max),
                     torch.where(uphill, dt * _F_DEC, dt))
    alpha = torch.where(grow, alpha * _F_ALPHA,
                        torch.where(uphill, torch.full_like(alpha, _ALPHA0),
                                    alpha))
    v = v + dt[:, None, None] * f
    dx = dt[:, None, None] * v
    step_len = torch.sqrt(torch.sum(dx * dx, -1, keepdim=True) + 1e-12)
    dx = dx * torch.clamp(max_step / step_len, max=1.0)
    return x + dx * nm, v, dt, alpha, n_pos, uphill


def fire_steps(x0: torch.Tensor, ff: FFBatch, n_steps: int, record,
               dt0: float = 2e-3, dt_max: float = 1e-2,
               max_step: float = 0.02) -> torch.Tensor:
    """``n_steps`` FIRE steps from x0 as a loop (the plain version);
    ``record(k, uphill)`` receives step k's (B,) bool branch tensor."""
    state = fire_state(x0, dt0)
    for k in range(n_steps):
        *state, uphill = fire_step(*state, x0, ff, dt_max, max_step)
        record(k, uphill)
    return state[0]


def fire_buffers(x0: torch.Tensor, ff: FFBatch, n_steps: int,
                 dt0: float = 2e-3):
    """The tensors a step graph reads and writes, by name: x0, FIRE's
    state at its start (x a copy of x0: the step writes it), the step count
    (1,) and the (n_steps, B) branch history, and the topology's fields."""
    x, v, dt, alpha, n_pos = fire_state(x0, dt0)
    return dict(x0=x0, x=x.clone(), v=v, dt=dt, alpha=alpha, n_pos=n_pos,
                step=torch.zeros((1,), dtype=torch.int64, device=x0.device),
                history=torch.empty((n_steps, x0.shape[0]), dtype=torch.bool,
                                    device=x0.device),
                **{f.name: getattr(ff, f.name)
                   for f in dataclasses.fields(FFBatch)})


def fire_graph_step(x0, x, v, dt, alpha, n_pos, step, history, *,
                    dt_max: float = 1e-2, max_step: float = 0.02,
                    **topology):
    """The function a step graph captures: one :func:`fire_step` on
    :func:`fire_buffers`'s tensors, in place, its branch tensor written
    into row ``step`` of ``history``. Returns (x, history)."""
    *new, uphill = fire_step(x, v, dt, alpha, n_pos, x0, FFBatch(**topology),
                             dt_max, max_step)
    for buf, value in zip((x, v, dt, alpha, n_pos), new):
        buf.copy_(value)
    history.index_copy_(0, step, uphill[None])
    step.add_(1)
    return x, history


#: Captured FIRE steps, by step count, constants, device and every input's
#: shape and type (the batch size and term counts change per request: one
#: capture each, as JAX's jit retraces). On the H100 a step's capture takes
#: about 30 ms and holds 4-30 MiB for 55-172 molecules (PERF.md).
_GRAPHS = GraphCache(8)


def relax(x0: torch.Tensor, ff: FFBatch, n_steps: int = 200,
          dt0: float = 2e-3, dt_max: float = 1e-2,
          max_step: float = 0.02,
          uphill_log: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Batched FIRE relaxation; returns optimised coords (B, N, 3).

    FIRE (Bitzek et al., PRL 97, 170201): velocity mixed toward the downhill
    direction while the power F.v stays positive (growing the per-sample
    timestep), reset to zero on uphill steps. All adaptive state (dt, alpha,
    positive-step count) is per-sample. Per-atom displacements are
    trust-region capped at ``max_step`` Angstrom per iteration. ``ff`` holds
    tensors on x0's device. ``uphill_log``, when given, receives each step's
    (B,) bool tensor of samples that took the uphill branch (``P < 0``): the
    branch history by which two runs of one batch can be told apart.

    On CUDA tensors one step, its autograd forward and backward included,
    is a captured CUDA graph (``utils/cuda_graph.py``) over the state's
    static buffers, replayed ``n_steps`` times with no host work between
    replays; on CPU tensors a loop (:func:`fire_steps`).
    """
    consts = dict(dt_max=dt_max, max_step=max_step)
    if x0.device.type != "cuda" or not n_steps:    # no step: no graph
        def record(k, uphill):
            if uphill_log is not None:
                uphill_log.append(uphill)

        return fire_steps(x0, ff, n_steps, record, dt0=dt0, **consts)
    inputs = fire_buffers(x0, ff, n_steps, dt0)
    key = (n_steps, tuple(sorted(consts.items())), x0.device,
           tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
    graph = _GRAPHS.get(key, None, lambda: capture(
        functools.partial(fire_graph_step, **consts), inputs))
    x, history = graph(replays=n_steps, **inputs)
    if uphill_log is not None:
        uphill_log.extend(history.unbind(0))
    return x


def optimize_geometry(mols: List[Molecule], n_steps: int = 200,
                      device=None) -> List[Molecule]:
    """Relax a batch of molecules on ``device`` (``None``: the CUDA device;
    without one, raise); returns updated copies."""
    device = resolve_device(device)
    if not mols:
        return []
    n_pad = _pad8(max(m.num_atoms for m in mols))
    ff = to_device(build_ff_batch(mols, n_pad), device)
    x0 = np.zeros((len(mols), n_pad, 3), dtype=np.float32)
    for b, m in enumerate(mols):
        x0[b, : m.num_atoms] = m.coords
    with torch.no_grad():
        x = relax(torch.as_tensor(x0, device=device), ff,
                  n_steps=n_steps).cpu().numpy()
    out = []
    for b, m in enumerate(mols):
        c = m.copy()
        c.coords = x[b, : m.num_atoms].astype(np.float64)
        out.append(c)
    return out
