"""What the EDM GEOM-Drugs training cell's driver and readers share: its
corpus of all-atom molecules, and the float32 edge kernels' share of their
roofline from the trace and the program's launch counts.

The corpus is ``batches`` batches of ``batch`` molecules from the seed. In
batch k the largest molecule has ``largest[order(k)]`` atoms, the sizes
cycled in an order drawn from the seed, at a place in the batch drawn too;
the others have sizes uniform on ``[smallest, largest_other]``. Elements
are drawn from ``elements`` (symbol -> share), coordinates are a chain of
steps in random directions with lengths uniform on ``step_A``, moved to
zero centre of mass. Molecules are (atomic numbers, coordinates) numpy
pairs.
"""

from __future__ import annotations

import re

import numpy as np

from . import devtrace, flops
from .reference.train_drugs import ATOMIC_NUMBERS
from .traffic import derive_seed

#: Device events of the float32 edge kernels: forward or backward, the
#: N <= 128 kernel or the wide one, the mode.
_F32 = re.compile(r"edge_mlp_(f32|bwd_f32)(_wide)?_kernel<(true|false)")
#: Edge rows of a kernel tile: a pass at more nodes runs the wide kernel.
TILE_ROWS = 128


def size_order(wl: dict, seed: int):
    """The largest molecules' sizes in the order the batches cycle them."""
    sizes = wl["largest"]
    perm = np.random.default_rng(derive_seed(seed, 1)).permutation(
        len(sizes))
    return [sizes[k] for k in perm]


def corpus(wl: dict, seed: int):
    """The corpus: [batch: [(atomic numbers, coordinates)]]."""
    symbols = list(wl["elements"])
    z_vals = np.array([ATOMIC_NUMBERS[s] for s in symbols])
    p = np.array([wl["elements"][s] for s in symbols], dtype=np.float64)
    p /= p.sum()
    lo, hi = wl["step_A"]
    order = size_order(wl, seed)
    out = []
    for k in range(wl["batches"]):
        rng = np.random.default_rng(derive_seed(seed, 2, k))
        sizes = rng.integers(wl["smallest"], wl["largest_other"] + 1,
                             size=wl["batch"]).tolist()
        sizes[int(rng.integers(wl["batch"]))] = order[k % len(order)]
        mols = []
        for n in sizes:
            z = rng.choice(z_vals, size=n, p=p)
            steps = rng.normal(size=(n - 1, 3))
            steps *= rng.uniform(lo, hi, size=(n - 1, 1)) / np.linalg.norm(
                steps, axis=1, keepdims=True)
            pos = np.concatenate([np.zeros((1, 3)), np.cumsum(steps, 0)])
            mols.append((z, pos - pos.mean(axis=0)))
        out.append(mols)
    return out


def f32_roofline(run, backward: bool, wide_only: bool):
    """100 x (the least seconds of the traced steps' float32 edge launches,
    each reckoned at its step's (molecules, padded nodes) by
    ``flops.edge_pass_bound``) / (their device seconds). ``backward``: the
    backward kernel's launches, each with the library GEMM launched after
    it (its [dW1 | db1] product), against the backward's bound; else the
    forward kernel's (the forward and, under rematerialisation, its
    recompute). ``wide_only``: only the wide kernel's launches (steps
    padded past 128 nodes).

    A step's device work runs after its host span (the next step's draws
    wait for it), so launches are not matched to steps by time: the
    traced steps' launches of each kernel come in the steps' order, and
    each step's count is the program's (``ops/gcl_kernel.py``'s LAUNCHES,
    recorded by the driver a step). None where the run holds no trace, no
    count, or launches that the counts do not account for."""
    tr = run.trace
    units = run.traced_units
    if tr is None or not units or any(
            u.get("shape") is None or u.get("launches") is None
            for u in units):
        return None
    cfg = run.config
    H, E = cfg["hidden_nf"], cfg["edge_feat_nf"]
    # the launches of each (backward, wide) kernel in order: (mode, seconds)
    found = {(b, w): [] for b in (False, True) for w in (False, True)}
    last = None
    for name, s, e in sorted(tr.in_window(), key=lambda d: d[1]):
        m = _F32.search(name)
        if m is None:
            if (last is not None and devtrace.categorize(name)
                    == "matmul (GEMM)"):
                last[1] += e - s
                last = None
            continue
        back = m.group(1) == "bwd_f32"
        rec = ["gcl" if m.group(3) == "true" else "coord", e - s]
        found[back, m.group(2) is not None].append(rec)
        last = rec if back else None
    bound = seconds = 0.0
    taken = {k: 0 for k in found}
    for u in units:
        B, N = u["shape"]
        wide = N > TILE_ROWS
        keys = ("gcl_bwd", "coord_bwd") if backward else ("gcl", "coord")
        n = sum(u["launches"].get(k, 0) for k in keys)
        queue, at = found[backward, wide], taken[backward, wide]
        if at + n > len(queue):
            return None
        got = queue[at:at + n]
        taken[backward, wide] = at + n
        if [r[0] for r in got].count("gcl") != u["launches"].get(keys[0], 0):
            return None
        if wide_only and not wide:
            continue
        for mode, sec in got:
            bound += flops.edge_pass_bound(B, N, H, E, "float32", mode,
                                           backward=backward)[0]
            seconds += sec
    if any(taken[backward, w] != len(found[backward, w])
           for w in (False, True)) or seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds
