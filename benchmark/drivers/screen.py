"""Screening traffic: the library's batch API for screening pipelines,
``ScreeningDriver(generator).screen(references, ...)``, from one client
that waits for each call.

Unit i screens ``refs_per_unit`` protocol references, those of positions
``refs_per_unit i .. refs_per_unit (i + 1) - 1`` of the references cycled
in the seed's order, with ``n_samples`` samples each at ``variance``,
scored (``score``) and ``queue_depth`` requests ahead: the driver's worker
thread samples the next reference on a stream of its own while the
caller's thread standardises, bonds and scores the previous one. Set-up
builds the generator of the configuration and its screening driver, loads
the benchmark's weights, and screens one reference of each node bucket the
references use, which captures every sampler graph the window replays.

What is judged: one reference in each of ``judge_requests`` units drawn
from the seed among the first ``judge_within`` (among them the unit of the
largest reference, judged at that reference), read through observation
points of the screen's own path that call through unchanged: the worker's
``_sample`` (the state of the generator's random stream as the request
starts, and its samples, decoded as the screen decodes them) and the bond
predictor's module function ``adj_mat_seer_forward`` (its inputs as the
screen featurised the samples, and its logits). The comparison is the
sampling driver's (``sample.Driver.judge``): the positions, the atom types
and the bond logits against the plain reference's, the sizes drawn and
the featurisation exact, under the protocol cell's limits.

Each unit reports a request's mean stage seconds (``stages``, under the
generator's stage names): the worker's sampling, timed around the
screen's own ``_sample``, and the caller's chemistry and bond prediction
from the screen's ``last_metrics``.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from ..traffic import derive_seed, make_protocol_refs, request_order
from . import common, sample


class Driver(sample.Driver):
    # -- set-up --------------------------------------------------------

    def setup(self):
        import torch
        from ml_conformer_generator_tpu_torch import generator as gmod
        from ml_conformer_generator_tpu_torch.chem.mol import Molecule
        from ml_conformer_generator_tpu_torch.parallel.screening import (
            ScreeningDriver)

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
        self._fit_widths(gen)
        self.w_egnn, self.w_adj = common.weights(run)
        gen.sampler.dynamics.load_state_dict(self.w_egnn)
        gen.adj_model.load_state_dict(self.w_adj)
        self.gen = gen
        self.sd = ScreeningDriver(gen)

        self.refs = make_protocol_refs(wl["references"], wl["refs_seed"])
        self.mols = [Molecule(z, pos, []) for z, pos in self.refs]
        k = wl["refs_per_unit"]
        self.order = request_order(wl, run.seed, wl["references"])
        units = wl["judge_within"]
        size = lambda r: len(self.refs[r][0])
        rng = np.random.default_rng(derive_seed(run.seed, 4))
        # (unit, position) of the largest reference the first units screen
        largest = max(((i, p) for i in range(units) for p in range(k)),
                      key=lambda ip: size(self.unit_refs(ip[0])[ip[1]]))
        others = rng.choice([i for i in range(units) if i != largest[0]],
                            wl["judge_requests"] - 1, replace=False).tolist()
        self.judge_at = {largest[0]: largest[1]}
        self.judge_at.update({i: int(rng.integers(k)) for i in others})
        self.judge_ids = sorted(self.judge_at)
        self._observe()
        if self.control:
            self._put_control_in_place()
            self.sd._sampler.generate = self.gen.sampler.generate
            return
        # one reference of each node bucket: every graph captured
        seen, warm = set(), []
        for r, (z, _) in enumerate(self.refs):
            hi = min(len(z) + wl["variance"], cfg["max_n_nodes"])
            if sample.bucket(hi, cfg["node_bucket"]) not in seen:
                seen.add(sample.bucket(hi, cfg["node_bucket"]))
                warm.append(self.mols[r])
        self._screen(warm)

    def _fit_widths(self, gen):
        """The configured widths where they differ from the generator's
        own (the CPU tests' tiny configurations)."""
        import torch
        from ml_conformer_generator_tpu_torch.config import AdjMatSeerConfig
        from ml_conformer_generator_tpu_torch.diffusion.edm import EDMSampler
        from ml_conformer_generator_tpu_torch.models.adj_mat_seer import (
            AdjMatSeer)
        from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics

        cfg, dev = self.cfg, self.run.device
        egnn_cfg = common.egnn_config(cfg)
        if gen.egnn_cfg != egnn_cfg or gen.diff_cfg != common.diffusion_config(
                cfg):
            dtype = (torch.bfloat16 if cfg["compute_dtype"] == "bfloat16"
                     else torch.float32)
            gen.sampler = EDMSampler(
                EGNNDynamics(egnn_cfg).to(dev, dtype).eval(),
                common.diffusion_config(cfg))
        adj_cfg = AdjMatSeerConfig(
            dimension=cfg["dimension"], n_hidden=cfg["n_hidden"],
            embedding_dim=cfg["embedding_dim"],
            num_embeddings=cfg["num_embeddings"],
            num_bond_types=cfg["num_bond_types"])
        if gen.adj_cfg != adj_cfg:
            gen.adj_model = AdjMatSeer(adj_cfg).to(dev).eval()

    def _observe(self):
        """The sampling driver's observation of the bond predictor, and the
        screen's own sampling and chemistry observed per request: a record
        (or None) is queued at each dispatch; the worker takes the records
        in dispatch order, as it samples, and the caller's thread takes the
        request's record while it finishes the request."""
        from ml_conformer_generator_tpu_torch.chem.featurize import (
            samples_to_molecules)

        super()._observe()
        sd, gen = self.sd, self.gen
        dispatch, sample_fn, finish = sd._dispatch, sd._sample, sd._finish
        self.records = deque()      # of the screen's requests, in order
        self.to_sample = deque()
        self.by_future = {}

        def observed_dispatch(reference, n_samples, variance):
            rec = self.records.popleft() if self.records else None
            self.to_sample.append(rec)
            out = dispatch(reference, n_samples, variance)
            self.by_future[id(out[1])] = rec
            return out

        def observed_sample(*a, **k):
            rec = self.to_sample.popleft()
            if rec is not None:
                rec["state"] = gen._generator.get_state()
            t0 = time.perf_counter()
            x, h, node_mask = sample_fn(*a, **k)
            self.sampling_s.append(time.perf_counter() - t0)
            self.atoms += node_mask.sum(axis=(1, 2)).astype(int).tolist()
            if rec is not None:
                rec["raw"] = samples_to_molecules(x, h, node_mask,
                                                  gen.atom_decoder)
            return x, h, node_mask

        def observed_finish(dispatched, timer=None):
            self.current = self.by_future.pop(id(dispatched[1]))
            try:
                return finish(dispatched, timer)
            finally:
                self.current = None

        sd._dispatch, sd._sample, sd._finish = (
            observed_dispatch, observed_sample, observed_finish)

    # -- the window ----------------------------------------------------

    def unit_refs(self, i):
        """The references unit i screens: the seeded order, cycled."""
        k = self.wl["refs_per_unit"]
        return [self.order[(k * i + p) % len(self.order)] for p in range(k)]

    def ref_of(self, i):
        """The reference judged in unit i."""
        return self.unit_refs(i)[self.judge_at[i]]

    def _screen(self, mols, judged=None):
        """One screen of ``mols``; ``judged``: the position whose request
        is recorded."""
        wl = self.wl
        self.atoms, self.sampling_s = [], []
        records = [{} if p == judged else None for p in range(len(mols))]
        self.records = deque(records)
        rep = self.sd.screen(mols, n_samples=wl["n_samples"],
                             variance=wl["variance"], score=wl["score"],
                             queue_depth=wl["queue_depth"])
        return rep, (records[judged] if judged is not None else None)

    def unit(self, i):
        wl = self.wl
        refs = self.unit_refs(i)
        rep, rec = self._screen([self.mols[r] for r in refs],
                                self.judge_at.get(i))
        if rec is not None:
            self.judged[i] = rec
        return {"samples": wl["n_samples"] * len(refs), "refs": refs,
                "valid": rep.n_valid, "atoms": list(self.atoms),
                "stages": self.stages(len(refs))}

    def stages(self, n):
        """A request's mean stage seconds in the last screen of ``n``
        references, under the generator's stage names (``layers.
        mean_stage_ms``): the worker's sampling of each request (its
        draws, the sampler's graph replay and the copy to the host), and
        the caller's chemistry from the screen's ``last_metrics``: the
        featurisation, the bond predictor on the card, the bonds and the
        standardisation. The caller's wait for the worker and the scoring,
        per request too, under their screen names."""
        m = self.sd.last_metrics
        per = lambda *keys: sum(m.get(f"{k}_s", 0.0) for k in keys) / n
        return {"edm_sampling_s": sum(self.sampling_s) / n,
                "featurize_s": per("host_chem/featurize"),
                "bond_prediction_s": per("host_chem/adj_device"),
                "standardize_s": per("host_chem/bonds",
                                     "host_chem/standardize"),
                "device_wait_s": per("device_wait"), "score_s": per("score")}

    def release(self):
        self.sd._pool.shutdown(wait=True)
        del self.sd
        super().release()
