"""Sampling traffic: ``generate_conformers`` requests from one client that
waits for each (a library caller, a screening script).

Request i asks for ``n_samples`` molecules shaped like protocol reference
``request_order(i)`` at ``variance``, with the geometry optimisation on.
Set-up builds the generator of the configuration, loads the benchmark's
weights, and makes one request for each node bucket the references use,
which captures every sampler graph the window replays.

What is judged, for a sample of the window's requests drawn from the seed
(the one with the largest reference among them), read through two
observation points of the timed path, which call through unchanged:

* the instance's ``edm_samples`` (the sampler stage): the state of the
  generator's random stream as the request starts, and the bond-less
  samples it returns;
* the bond predictor's module function ``adj_mat_seer_forward``: its
  inputs as the program featurised the samples, and its logits.

The reference draws the request's sizes and noise again from that state,
runs the plain sampler on a sample of rows (the largest among them) and
the plain bond predictor on the program's inputs, and compares, over every
judged atom: the rms distance of the positions from the reference's
(``x_rms``, each over its sample's rms radius; for a bfloat16
configuration ``x_ratio``, that distance over the one of the reference
re-run with bfloat16 products, since a seed's weights set how far any
rounding moves the positions), the mean gap by which each
chosen atom type's score lies below the reference's best (``type_gap_mean``,
over the sample's rms score), and, widest over every pair, the bond
logits' distance from the reference's (``bond_err``, over the sample's rms
logit); the sizes drawn and the featurisation (elements and distances
against the samples) must agree exactly.
"""

from __future__ import annotations

import numpy as np

from ..traffic import derive_seed, make_protocol_refs, request_order
from . import common

#: Atomic numbers of the sampler's atom classes, in class order.
_CLASS_Z = (6, 7, 8, 9, 15, 16, 17, 35)


def bucket(n: int, size: int) -> int:
    return -(-n // size) * size


def context_of(coords, cfg):
    """The normalised principal moments (unit masses) of a conformer."""
    c = np.asarray(coords, dtype=np.float64)
    c = c - c.mean(axis=0)
    inertia = np.eye(3) * (c * c).sum() - c.T @ c
    return ((np.linalg.eigvalsh(inertia) - np.asarray(cfg["context_norms"]
                                                      ["mean"]))
            / np.asarray(cfg["context_norms"]["mad"]))


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.wl = run.config, run.workload
        self.control = run.control
        self.judged = {}
        self.current = None

    # -- set-up --------------------------------------------------------

    def setup(self):
        import torch
        from ml_conformer_generator_tpu_torch import generator as gmod
        from ml_conformer_generator_tpu_torch.chem.mol import Molecule
        from ml_conformer_generator_tpu_torch.models.adj_mat_seer import (
            AdjMatSeer)
        from ml_conformer_generator_tpu_torch.config import AdjMatSeerConfig
        from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
        from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics

        run, cfg, wl = self.run, self.cfg, self.wl
        self.torch = torch
        if run.device == "cuda":
            common.enable_kernel_cache()
        gen = gmod.MLConformerGenerator(
            diffusion_steps=cfg["timesteps"], min_n_nodes=cfg["min_n_nodes"],
            max_n_nodes=cfg["max_n_nodes"],
            context_norms={k: tuple(v) for k, v in
                           cfg["context_norms"].items()},
            seed=derive_seed(run.seed, 11),
            compute_dtype=cfg["compute_dtype"],
            node_bucket=cfg["node_bucket"], device=run.device)
        egnn_cfg = common.egnn_config(cfg)
        if gen.egnn_cfg != egnn_cfg or gen.diff_cfg != common.diffusion_config(
                cfg):
            # widths other than the generator's own (the CPU tests' tiny
            # configurations): the same classes at the configured sizes
            dtype = (torch.bfloat16 if cfg["compute_dtype"] == "bfloat16"
                     else torch.float32)
            gen.sampler = EDMSampler(
                EGNNDynamics(egnn_cfg).to(run.device, dtype).eval(),
                common.diffusion_config(cfg))
        adj_cfg = AdjMatSeerConfig(
            dimension=cfg["dimension"], n_hidden=cfg["n_hidden"],
            embedding_dim=cfg["embedding_dim"],
            num_embeddings=cfg["num_embeddings"],
            num_bond_types=cfg["num_bond_types"])
        if gen.adj_cfg != adj_cfg:
            gen.adj_model = AdjMatSeer(adj_cfg).to(run.device).eval()
        self.w_egnn, self.w_adj = common.weights(run)
        gen.sampler.dynamics.load_state_dict(self.w_egnn)
        gen.adj_model.load_state_dict(self.w_adj)
        self.gen = gen

        self.refs = make_protocol_refs(wl["references"], wl["refs_seed"])
        self.mols = [Molecule(z, pos, []) for z, pos in self.refs]
        self.order = request_order(wl, run.seed, wl["references"])
        count = wl["judge_within"]
        rng = np.random.default_rng(derive_seed(run.seed, 4))
        largest = max(range(count), key=lambda i: len(self.refs[
            self.ref_of(i)][0]))
        rest = [i for i in range(count) if i != largest]
        self.judge_ids = sorted([largest] + rng.choice(
            rest, wl["judge_requests"] - 1, replace=False).tolist())
        self._observe()
        if self.control:
            # nothing to capture: the reference runs in the program's place
            self._put_control_in_place()
            return
        # one request per node bucket of the traffic: every graph captured
        seen = set()
        for k, (z, _) in enumerate(self.refs):
            hi = min(len(z) + wl["variance"], cfg["max_n_nodes"])
            if bucket(hi, cfg["node_bucket"]) not in seen:
                seen.add(bucket(hi, cfg["node_bucket"]))
                self._request(k)

    def _observe(self):
        from ml_conformer_generator_tpu_torch.models import adj_mat_seer

        gen = self.gen
        edm_samples = gen.edm_samples
        self._fwd = adj_mat_seer.adj_mat_seer_forward

        def observed_edm_samples(*a, **k):
            cur = self.current
            if cur is not None:
                cur["state"] = gen._generator.get_state()
            mols = edm_samples(*a, **k)
            self.atoms = [m.num_atoms for m in mols]
            if cur is not None:
                cur["raw"] = mols
            return mols

        def observed_forward(model, elements, dist, adj):
            out = self._fwd(model, elements, dist, adj)
            if self.current is not None:
                self.current["bonds"] = (elements, dist, adj, out)
            return out

        gen.edm_samples = observed_edm_samples
        adj_mat_seer.adj_mat_seer_forward = observed_forward
        self._restore = (adj_mat_seer, self._fwd)

    def _put_control_in_place(self):
        """The reference in the program's place, in the control's formats:
        the sampler draws as the program does, from its generator."""
        import torch

        from ..reference import adj_mat_seer, edm

        cfg, (egnn_fmt, adj_fmt) = self.cfg, self.control

        def generate(generator, gamma, node_mask, edge_mask, context,
                     resample_steps=0, dtype=torch.float32):
            B, N, _ = node_mask.shape
            draws = [torch.cat([
                torch.randn((B, N, 3), generator=generator,
                            device=node_mask.device),
                torch.randn((B, N, 8), generator=generator,
                            device=node_mask.device)], -1)
                for _ in range(cfg["timesteps"] + 2)]
            noise = edm.mask_noise(torch.stack(draws), node_mask)
            em = edge_mask
            x, scores = edm.sample(self.w_egnn, cfg, noise, node_mask, em,
                                   context.float(), egnn_fmt)
            h = torch.nn.functional.one_hot(scores.argmax(-1), 8).float()
            return x, h * node_mask

        def forward(model, elements, dist, adj):
            return adj_mat_seer.forward(self.w_adj, cfg, elements, dist,
                                        adj, adj_fmt)

        self.gen.sampler.generate = generate
        self._fwd = forward

    # -- the window ----------------------------------------------------

    def _request(self, ref_index):
        wl = self.wl
        valid = self.gen.generate_conformers(
            self.mols[ref_index], n_samples=wl["n_samples"],
            variance=wl["variance"],
            optimise_geometry=wl["optimise_geometry"])
        return valid

    def ref_of(self, i):
        """The reference of request i: the seeded order, cycled."""
        return self.order[i % len(self.order)]

    def unit(self, i):
        wl = self.wl
        ref = self.ref_of(i)
        self.current = {} if i in self.judge_ids else None
        valid = self._request(ref)
        if self.current is not None:
            self.current["valid"] = valid
            self.judged[i] = self.current
        self.current = None
        hi = min(len(self.refs[ref][0]) + wl["variance"],
                 self.cfg["max_n_nodes"])
        return {"samples": wl["n_samples"], "ref": ref, "valid": len(valid),
                "atoms": self.atoms, "stages": dict(self.gen.last_metrics),
                "shape": (wl["n_samples"], bucket(hi, self.cfg["node_bucket"]))}

    def sync(self):
        if self.run.device == "cuda":
            self.torch.cuda.synchronize()

    def finish(self):
        """Requests to be judged that the window did not reach, made now."""
        for i in self.judge_ids:
            if i not in self.judged:
                self.unit(i)
        self.sync()

    def release(self):
        module, fwd = self._restore
        module.adj_mat_seer_forward = fwd
        del self.gen
        if self.run.device == "cuda":
            self.torch.cuda.empty_cache()

    # -- the judgement -------------------------------------------------

    def judge(self):
        import torch

        from ..reference import adj_mat_seer, edm
        from ..reference.precision import exact_float32

        cfg, wl, dev = self.cfg, self.wl, self.run.device
        lim = self.run.workload["limits"]
        dx, radius, gaps, dxs, bond_err = [], [], [], [], 0.0
        mismatch = {"sizes": 0, "featurize": 0}
        rng = np.random.default_rng(derive_seed(self.run.seed, 5))
        with exact_float32(), torch.no_grad():
            for i in self.judge_ids:
                d = self.judged[i]
                z_ref, pos = self.refs[self.ref_of(i)]
                lo = max(len(z_ref) - wl["variance"], cfg["min_n_nodes"])
                hi = min(len(z_ref) + wl["variance"], cfg["max_n_nodes"])
                N = bucket(hi, cfg["node_bucket"])
                B = wl["n_samples"]
                g = torch.Generator(device=dev)
                g.set_state(d["state"])
                n = torch.randint(lo, hi + 1, (B,), generator=g, device=dev)
                draws = torch.stack([torch.cat([
                    torch.randn((B, N, 3), generator=g, device=dev),
                    torch.randn((B, N, 8), generator=g, device=dev)], -1)
                    for _ in range(cfg["timesteps"] + 2)])
                n = n.tolist()
                raw = d["raw"]
                mismatch["sizes"] += sum(int(m.num_atoms != k)
                                         for m, k in zip(raw, n))
                if mismatch["sizes"]:
                    continue
                k = min(wl["judge_rows"], B)
                big = int(np.argmax(n))
                others = [r for r in range(B) if r != big]
                rows = sorted([big] + rng.choice(others, k - 1,
                                                 replace=False).tolist())
                for acc, got in zip((dx, radius, gaps, dxs),
                                    self._judge_samples(
                                        edm, draws, rows, [n[r] for r in rows],
                                        raw, context_of(pos, cfg))):
                    if got is not None:
                        acc.append(got)
                berr, bad = self._judge_bonds(adj_mat_seer, d, raw)
                bond_err = max(bond_err, berr)
                mismatch["featurize"] += bad
        dx, radius, gaps = (np.concatenate(a) if a else np.zeros(1)
                            for a in (dx, radius, gaps))
        values = {
            # positions' error over the sample's rms radius, rms over atoms
            "x_rms": float(np.sqrt(((dx / radius) ** 2).mean())),
            "type_gap_mean": float(gaps.mean()), "bond_err": bond_err}
        if dxs:
            # the error over what the stated precision's rounding alone
            # moves the positions (a bfloat16 configuration's)
            dxs = np.concatenate(dxs)
            values["x_ratio"] = float(np.sqrt((dx ** 2).mean() / max(
                (dxs ** 2).mean(), 1e-300)))
        # compared: the numbers the cell gives limits; the rest, and the
        # widest gaps, which swing with single atoms, are reported
        self.run.info = {k: v for k, v in values.items() if k not in lim}
        self.run.info.update(x_max=float((dx / radius).max()),
                             type_gap_max=float(gaps.max()),
                             type_flips=int((gaps > 0).sum()),
                             atoms=int(dx.size))
        checks = {k: (v, lim[k]) for k, v in values.items() if k in lim}
        checks["size_mismatch"] = (float(mismatch["sizes"]), 0.0)
        checks["featurize_mismatch"] = (float(mismatch["featurize"]), 0.0)
        return checks

    def _judge_samples(self, edm, draws, rows, n, raw, ctx):
        import torch

        cfg, dev = self.cfg, self.run.device
        R, Nr = len(rows), max(n)
        ar = torch.arange(Nr, device=dev)
        nm = (ar[None, :] < torch.tensor(n, device=dev)[:, None]).float()
        nm = nm[..., None]
        em = nm[:, :, None, :] * nm[:, None, :, :] * (
            1 - torch.eye(Nr, device=dev))[None, :, :, None]
        noise = edm.mask_noise(draws[:, rows, :Nr], nm)
        context = torch.tensor(ctx, dtype=torch.float32, device=dev).expand(
            R, Nr, 3) * nm
        x, scores = edm.sample(self.w_egnn, cfg, noise, nm, em, context)
        # the configuration's own precision, as a yardstick: how far its
        # rounding alone moves this run's positions
        stated = {"bfloat16": "bf16"}.get(cfg["compute_dtype"])
        xs = (edm.sample(self.w_egnn, cfg, noise, nm, em, context, stated)[0]
              .double().cpu().numpy() if stated else None)
        x, scores = x.double().cpu().numpy(), scores.double().cpu().numpy()
        cls = {z: c for c, z in enumerate(_CLASS_Z)}
        dx, radius, gaps, dxs = [], [], [], []
        for r, (row, k) in enumerate(zip(rows, n)):
            m = raw[row]
            xr, sr = x[r, :k], scores[r, :k]
            radius += [max(np.sqrt((xr ** 2).sum(-1).mean()), 1.0)] * k
            dx.append(np.sqrt(((m.coords - xr) ** 2).sum(-1)))
            if xs is not None:
                dxs.append(np.sqrt(((xs[r, :k] - xr) ** 2).sum(-1)))
            chosen = np.array([cls[int(z)] for z in m.atomic_nums])
            gap = sr.max(-1) - sr[np.arange(k), chosen]
            gaps.append(gap / max(np.sqrt((sr ** 2).mean()), 1e-30))
        return (np.concatenate(dx), np.array(radius), np.concatenate(gaps),
                np.concatenate(dxs) if dxs else None)

    def _judge_bonds(self, adj_mat_seer, d, raw):
        """(the widest gap of a bond logit from the reference's, over the
        rms of the sample's reference logits; rows whose featurisation
        disagrees with their sample)."""
        elements, dist, adj, out = d["bonds"]
        logits = adj_mat_seer.forward(self.w_adj, self.cfg, elements,
                                      dist.float(), adj.float())
        logits = logits.double().cpu().numpy()
        out = out.double().cpu().numpy()
        el, dm = elements.cpu().numpy(), dist.double().cpu().numpy()
        worst, bad = 0.0, 0
        for b, m in enumerate(raw):
            n = m.num_atoms
            pair = np.triu_indices(n, 1)
            diff = m.coords[:, None, :] - m.coords[None, :, :]
            dd = np.sqrt((diff ** 2).sum(-1))[pair]
            if (sorted(el[b, :n].tolist()) != sorted(m.atomic_nums.tolist())
                    or np.count_nonzero(el[b]) != n
                    or not np.allclose(np.sort(dm[b, :n, :n][pair]),
                                       np.sort(dd), rtol=1e-5, atol=1e-5)):
                bad += 1
                continue
            if n < 2:
                continue
            ref, got = logits[b, :n, :n][pair], out[b, :n, :n][pair]
            worst = max(worst, np.abs(got - ref).max()
                        / max(np.sqrt((ref ** 2).mean()), 1e-30))
        return float(worst), bad
