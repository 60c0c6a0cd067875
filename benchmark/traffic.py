"""Traffic of the benchmark, made from a workload file's parameters and the
run's seed: reference conformers and their order for the sampling mixes, a
corpus of molecules and its batches for training.

The references are the evaluation protocol's synthetic conformers
(:func:`make_protocol_refs`, a copy of the JAX system's ``bench.py``
generator, also copied in ``scripts_torch/protocol.py``): sizes drawn with
``integers(15, 40)`` and sorted, each a self-avoiding random walk of 1.5 A
steps. The set is fixed by the workload's ``refs_seed``, so every run seed
sends the same sizes and differs in their order and in everything the
program draws. Molecules are (atomic numbers, coordinates) numpy pairs.
"""

from __future__ import annotations

import numpy as np

_MASK64 = (1 << 64) - 1


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed (splitmix64 chained over
    ``path``): the streams of one run never share a seed."""
    z = seed & _MASK64
    for p in (0x5EED, *path):
        z = (z ^ (p & _MASK64)) & _MASK64
        z = (z + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


def make_protocol_refs(n_requests: int, seed: int = 0):
    """Synthetic reference conformers spanning the screen protocol's sizes
    (all carbon): [(atomic numbers, coordinates)], sorted by size."""
    rng = np.random.default_rng(seed)
    sizes = sorted(int(n) for n in rng.integers(15, 40, size=n_requests))
    refs = []
    for n in sizes:
        pos = [np.zeros(3)]
        while len(pos) < n:
            step = rng.normal(size=3)
            cand = pos[-1] + 1.5 * step / np.linalg.norm(step)
            # self-avoidance keeps the moments in a molecule-like range
            if all(np.linalg.norm(cand - p) > 1.2 for p in pos[-8:]):
                pos.append(cand)
        refs.append((np.full(n, 6), np.asarray(pos)))
    return refs


def request_order(workload: dict, seed: int, count: int):
    """Indices into the references of the first ``count`` requests: the
    references cycled in an order drawn from the seed."""
    n = workload["references"]
    perm = np.random.default_rng(derive_seed(seed, 1)).permutation(n)
    return [int(perm[i % n]) for i in range(count)]


def corpus(workload: dict, seed: int):
    """The training corpus: ``copies`` molecules, each a protocol reference
    (cycled) with its atoms jittered by ``jitter_A`` and its elements drawn
    from ``elements`` (atomic number -> share), from the seed. Sizes are
    the references', so every seed trains on the same sizes."""
    refs = make_protocol_refs(workload["references"], workload["refs_seed"])
    rng = np.random.default_rng(derive_seed(seed, 2))
    z_vals = np.array([int(k) for k in workload["elements"]])
    p = np.array(list(workload["elements"].values()), dtype=np.float64)
    out = []
    for i in range(workload["copies"]):
        _, pos = refs[i % len(refs)]
        z = rng.choice(z_vals, size=len(pos), p=p / p.sum())
        out.append((z, pos + rng.normal(scale=workload["jitter_A"],
                                        size=pos.shape)))
    return out


def epoch_batches(n_mols: int, batch: int, seed: int, epoch: int):
    """Index lists of one epoch's batches: a permutation drawn from the
    seed and the epoch, cut into whole batches."""
    order = np.random.default_rng(derive_seed(seed, 3, epoch)).permutation(
        n_mols)
    return [order[s:s + batch].tolist()
            for s in range(0, n_mols - batch + 1, batch)]
