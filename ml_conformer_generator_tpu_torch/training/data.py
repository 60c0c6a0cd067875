"""Training data pipeline: molecule files -> padded batches.

A copy of ``ml_conformer_generator_tpu/training/data.py`` (numpy and a
thread; the port imports nothing of the JAX package): fixed padded shapes,
zero-CoM positions, one-hot atom classes, per-molecule principal-MOI context
(the same conditioning the generator uses at inference,
``ops/moi.get_context_shape``), and a background prefetch thread that keeps
host featurisation off the device's critical path. The train step moves
each batch to its device.

:class:`MoleculeDataset` is ML Conformer Generator's (heavy atoms, 15-39 of
8 elements, MOI context, every batch padded to the dataset's largest).
:class:`AllAtomDataset` is for an unconditioned all-atom model, EDM trained
on GEOM-Drugs (``config.edm_geom_drugs``): hydrogens kept, atom types over
an atom decoder, no context, and each batch padded to its own largest
molecule rounded up to the node bucket, as EDM's GEOM-Drugs loader pads
each batch to its largest; the train step keeps a graph per batch shape.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import (CONTEXT_NORMS, ELEMENTS_TO_CLASS,
                      GEOM_DRUGS_ATOM_DECODER, GEOM_DRUGS_MAX_N_NODES,
                      MAX_N_NODES, MIN_N_NODES, NUM_ATOM_CLASSES)
from ..chem.io import read_sdf
from ..chem.mol import Molecule
from ..chem.periodic import atomic_num
from ..utils.masks import pad_to_bucket
from ..utils.metrics import span

__all__ = ["AllAtomDataset", "MoleculeDataset", "batches", "prefetch"]


def _edge_mask(node_mask: np.ndarray) -> np.ndarray:
    """(B, N, N, 1): pairs of real nodes, no self-edges."""
    N = node_mask.shape[1]
    edge_mask = node_mask[:, :, None, 0:1] * node_mask[:, None, :, 0:1]
    eye = np.eye(N, dtype=np.float32)[None, :, :, None]
    return edge_mask * (1.0 - eye)


class MoleculeDataset:
    """In-memory molecule set with filtering + featurisation.

    Molecules outside [min_n_nodes, max_n_nodes] heavy atoms or with elements
    the model cannot emit are dropped (the generator's constants,
    ``config.py``).
    """

    def __init__(self, mols: Sequence[Molecule],
                 min_n_nodes: int = MIN_N_NODES,
                 max_n_nodes: int = MAX_N_NODES):
        self.mols: List[Molecule] = []
        for mol in mols:
            m = mol.remove_hs()
            if not (min_n_nodes <= m.num_atoms <= max_n_nodes):
                continue
            if any(int(z) not in ELEMENTS_TO_CLASS for z in m.atomic_nums):
                continue
            self.mols.append(m)
        self.max_n_nodes = max_n_nodes
        #: Padded shapes a batch of one size takes: every batch is padded
        #: to ``n_pad``.
        self.batch_shapes = 1

    @classmethod
    def from_sdf(cls, path: str, **kw) -> "MoleculeDataset":
        with open(path) as f:
            return cls(read_sdf(f.read()), **kw)

    def __len__(self) -> int:
        return len(self.mols)

    def featurize(self, indices: Sequence[int], n_pad: Optional[int] = None
                  ) -> Dict[str, np.ndarray]:
        """Padded batch dict: x (B,N,3) zero-CoM f32, h (B,N,C) one-hot,
        node_mask (B,N,1), edge_mask (B,N,N,1), context (B,N,3) normalised.
        ``n_pad``: N, default the dataset's ``max_n_nodes``."""
        B = len(indices)
        N = n_pad or self.max_n_nodes
        x = np.zeros((B, N, 3), dtype=np.float32)
        h = np.zeros((B, N, NUM_ATOM_CLASSES), dtype=np.float32)
        node_mask = np.zeros((B, N, 1), dtype=np.float32)
        context = np.zeros((B, N, 3), dtype=np.float32)
        mean = np.asarray(CONTEXT_NORMS["mean"], dtype=np.float32)
        mad = np.asarray(CONTEXT_NORMS["mad"], dtype=np.float32)
        for b, idx in enumerate(indices):
            m = self.mols[idx]
            n = m.num_atoms
            coords = m.coords - m.coords.mean(axis=0)
            x[b, :n] = coords
            for a, z in enumerate(m.atomic_nums):
                h[b, a, ELEMENTS_TO_CLASS[int(z)]] = 1.0
            node_mask[b, :n, 0] = 1.0
            # conditioning: the molecule's own principal MOI (unit masses)
            d2 = (coords ** 2).sum(axis=1)
            moi = np.eye(3) * d2.sum() - coords.T @ coords
            eig = np.sort(np.linalg.eigvalsh(moi)).astype(np.float32)
            context[b, :n] = (eig - mean) / mad
        return {"x": x, "h": h, "node_mask": node_mask,
                "edge_mask": _edge_mask(node_mask), "context": context}


class AllAtomDataset:
    """In-memory all-atom molecule set for an unconditioned model (EDM
    trained on GEOM-Drugs with hydrogens): hydrogens kept, one-hot atom
    types over ``atom_decoder`` (class -> element symbol, default
    ``config.GEOM_DRUGS_ATOM_DECODER``), no context.

    Molecules with an element the decoder lacks or more than
    ``max_n_nodes`` atoms are dropped. A batch is padded to its largest
    molecule rounded up to ``node_bucket`` (181 atoms pad to 184).
    """

    def __init__(self, mols: Sequence[Molecule],
                 atom_decoder: Dict[int, str] = GEOM_DRUGS_ATOM_DECODER,
                 max_n_nodes: int = GEOM_DRUGS_MAX_N_NODES,
                 node_bucket: int = 8):
        self.classes = {atomic_num(sym): c for c, sym in atom_decoder.items()}
        self.mols: List[Molecule] = [
            m for m in mols if 0 < m.num_atoms <= max_n_nodes
            and all(int(z) in self.classes for z in m.atomic_nums)]
        self.max_n_nodes = max_n_nodes
        self.node_bucket = node_bucket
        #: Padded shapes a batch of one size may take: one a node bucket up
        #: to ``max_n_nodes`` (23 through 184).
        self.batch_shapes = -(-max_n_nodes // node_bucket)

    @classmethod
    def from_sdf(cls, path: str, **kw) -> "AllAtomDataset":
        with open(path) as f:
            return cls(read_sdf(f.read()), **kw)

    def __len__(self) -> int:
        return len(self.mols)

    def featurize(self, indices: Sequence[int], n_pad: Optional[int] = None
                  ) -> Dict[str, np.ndarray]:
        """Padded batch dict: x (B,N,3) zero-CoM f32, h (B,N,C) one-hot
        over the decoder's C types, node_mask (B,N,1), edge_mask
        (B,N,N,1), context (B,N,0). ``n_pad``: N, default the batch's
        largest molecule rounded up to the node bucket."""
        mols = [self.mols[i] for i in indices]
        B = len(mols)
        N = n_pad or pad_to_bucket(max(m.num_atoms for m in mols),
                                   self.node_bucket)
        x = np.zeros((B, N, 3), dtype=np.float32)
        h = np.zeros((B, N, len(self.classes)), dtype=np.float32)
        node_mask = np.zeros((B, N, 1), dtype=np.float32)
        for b, m in enumerate(mols):
            n = m.num_atoms
            x[b, :n] = m.coords - m.coords.mean(axis=0)
            h[b, np.arange(n), [self.classes[int(z)]
                                for z in m.atomic_nums]] = 1.0
            node_mask[b, :n, 0] = 1.0
        return {"x": x, "h": h, "node_mask": node_mask,
                "edge_mask": _edge_mask(node_mask),
                "context": np.zeros((B, N, 0), dtype=np.float32)}


def batches(dataset, batch_size: int, *,
            rng: Optional[np.random.Generator] = None,
            n_pad: Optional[int] = None, drop_remainder: bool = True
            ) -> Iterator[Dict[str, np.ndarray]]:
    """One epoch of shuffled, padded batches of a :class:`MoleculeDataset`
    (every batch padded to ``n_pad``, default the dataset's largest: one
    shape throughout) or an :class:`AllAtomDataset` (default: each batch
    to its own largest, bucketed)."""
    rng = rng or np.random.default_rng(0)
    order = rng.permutation(len(dataset))
    end = (len(order) // batch_size * batch_size if drop_remainder
           else len(order))
    for s in range(0, end, batch_size):
        idx = order[s: s + batch_size]
        if drop_remainder and len(idx) < batch_size:
            break
        yield dataset.featurize(idx.tolist(), n_pad)


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue, so host
    featurisation of batch k+1 overlaps device compute of batch k."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with span("mlcg.data.wait"):
            item = q.get()
        if item is _END:
            return
        yield item
