"""Training traffic: the EDM train step and the EMA update on every step,
driven as ``training.loop.train`` drives them, on batches of a corpus.

Set-up builds one training object, the denoiser with the benchmark's
weights, its AdamW state and ``make_train_step``'s step on the one-device
mesh, and its moving average; it drives that object through its first
``judge_steps`` steps (the first captures the step's graph and the
average's), through the same call and feed as the window, on batches that
share no molecule. What the optimizer and the weights hold after them is
kept: the first gradient (AdamW's first moment after step 1, over 1 -
beta1), the weights and the moving average after the last. The window
goes on with the same object.

The reference follows the same steps from the same weights, batches and
draws, and the comparison takes each step's loss (``loss_gap``), and by
the worst leaf the norm of the first gradient (``grad_gap``), of the
weights' change (``change_gap``) and of the average's change
(``ema_gap``): the gap between the program's norm and the reference's,
over the reference's norm of that leaf or of the median leaf, whichever is
larger. Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the changes.
"""

from __future__ import annotations

import copy

import numpy as np

from ..traffic import corpus, derive_seed, epoch_batches
from ..weights import make_weights
from . import common


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg, self.wl = run.config, run.workload

    def _feed(self):
        """The batches of every epoch, featurised by the program's data
        pipeline, with the epoch's molecules in the seed's order."""
        wl, epoch = self.wl, 0
        while True:
            for idx in epoch_batches(len(self.corpus), wl["batch"],
                                     self.run.seed, epoch):
                yield self.dataset.featurize(idx, wl["n_pad"])
            epoch += 1

    def setup(self):
        import torch
        from ml_conformer_generator_tpu_torch.chem.mol import Molecule
        from ml_conformer_generator_tpu_torch.diffusion.schedule import (
            gamma_schedule)
        from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
        from ml_conformer_generator_tpu_torch.parallel import make_mesh
        from ml_conformer_generator_tpu_torch.training import (
            MoleculeDataset, prefetch)
        from ml_conformer_generator_tpu_torch.training.loop import ema_update_
        from ml_conformer_generator_tpu_torch.training.step import (
            init_train_state, make_optimizer, make_train_step)

        run, cfg, wl = self.run, self.cfg, self.wl
        dev = run.device
        self.torch, self.ema_update_ = torch, ema_update_
        if dev == "cuda":
            common.enable_kernel_cache()
        egnn_cfg = common.egnn_config(cfg)
        diff_cfg = common.diffusion_config(cfg)
        self.w0, _ = common.weights(run)
        with torch.device(dev):
            model = EGNNDynamics(egnn_cfg)
        model.load_state_dict(self.w0)
        self.model = model
        self.state = init_train_state(model, make_optimizer(
            lr=wl["lr"], weight_decay=wl["weight_decay"]))
        self.step = make_train_step(make_mesh(device=dev), egnn_cfg,
                                    diff_cfg)
        self.ema = copy.deepcopy(model).requires_grad_(False)
        self.gamma = torch.as_tensor(gamma_schedule(
            cfg["timesteps"], cfg["noise_precision"], cfg["schedule_power"]),
            dtype=torch.float32)
        self.gen_seed = derive_seed(run.seed, 12)
        self.generator = torch.Generator(device=dev).manual_seed(
            self.gen_seed)
        self.corpus = corpus(wl, run.seed)
        self.dataset = MoleculeDataset(
            [Molecule(z, pos, []) for z, pos in self.corpus],
            min_n_nodes=cfg["min_n_nodes"], max_n_nodes=cfg["max_n_nodes"])
        if len(self.dataset) != len(self.corpus):
            raise ValueError("the program's dataset dropped corpus molecules")
        self.feed = prefetch(self._feed(), depth=wl["prefetch"])
        self.count = 0
        beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        names = [n for n, _ in model.named_parameters()]
        self.losses = []
        for s in range(wl["judge_steps"]):
            metrics = self._step()
            self.losses.append(metrics["loss"])
            if s == 0:
                # a parameter the optimizer holds no moment of has had no
                # gradient from it
                opt_state = self.state.optimizer.state
                self.first_grad = {
                    n: (opt_state[p].get("exp_avg", torch.zeros_like(p))
                        / (1 - beta1)).clone()
                    for n, p in zip(names, model.parameters())}
        self.after = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
        self.ema_after = {n: p.detach().clone()
                          for n, p in self.ema.named_parameters()}

    def _step(self):
        batch = next(self.feed)
        metrics = self.step(self.model, self.state, self.generator, batch,
                            self.gamma)
        self.ema_update_(self.ema, self.model, self.wl["ema_decay"],
                         self.count)
        self.count += 1
        self.last_atoms = batch["node_mask"].sum(axis=(1, 2))
        return metrics

    def unit(self, i):
        self._step()
        return {"molecules": self.wl["batch"],
                "atoms": self.last_atoms.astype(int).tolist(),
                "shape": (self.wl["batch"], self.wl["n_pad"])}

    def sync(self):
        if self.run.device == "cuda":
            self.torch.cuda.synchronize()

    def finish(self):
        self.sync()
        self.losses = [float(x) for x in self.losses]

    def release(self):
        del self.model, self.state, self.step, self.ema, self.feed
        if self.run.device == "cuda":
            self.torch.cuda.empty_cache()

    def judge(self):
        ref = reference_steps(self.cfg, self.wl, self.run.seed,
                              self.run.device)
        return compare(self.losses, self.first_grad, self.after,
                       self.ema_after, *ref, w0=self.w0,
                       lim=self.run.workload["limits"])


def reference_steps(cfg, wl, seed, device, fmt="float32", fault=None):
    """The plain reference's first ``judge_steps`` steps of a run of
    ``seed``: (losses, first gradient, weights after, average after), with
    TF32 off. ``fmt``: the products' format (a control's); ``fault``:
    "half", the second half of every batch left out after the draws, the
    mean taken over the rest."""
    import torch

    from ..reference import train
    from ..reference.precision import exact_float32

    mols = corpus(wl, seed)
    batches = []
    for idx in epoch_batches(len(mols), wl["batch"], seed,
                             0)[:wl["judge_steps"]]:
        batches.append(train.featurize([mols[k] for k in idx], wl["n_pad"],
                                       cfg, device))
    w0, _ = make_weights(cfg, derive_seed(seed, 10), device)
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, 12))
    with exact_float32():
        return train.run_steps(w0, cfg, batches, g, wl["judge_steps"],
                               wl["lr"], wl["weight_decay"], wl["ema_decay"],
                               fmt, slice(0, wl["batch"] // 2)
                               if fault == "half" else None)


def _norms(tree):
    return {k: float(v.double().norm()) for k, v in tree.items()}


def compare(p_losses, p_first, p_after, p_ema, r_losses, r_first, r_after,
            r_ema, *, w0, lim):
    """The training checks from the program's readings (``p_``) and the
    reference's (``r_``): {name: (value, limit)}."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(p_losses, r_losses))
    rg = _norms(r_first)
    med = float(np.median(list(rg.values())))
    kept = [k for k in rg if rg[k] >= 1e-3 * med]

    def worst(p, r, keys):
        pn, rn = _norms(p), _norms(r)
        m = float(np.median([rn[k] for k in keys]))
        return max(abs(pn[k] - rn[k]) / max(rn[k], m) for k in keys)

    def change(tree):
        return {k: tree[k] - w0[k] for k in kept}

    return {"loss_gap": (loss_gap, lim["loss_gap"]),
            "grad_gap": (worst(p_first, r_first, list(rg)), lim["grad_gap"]),
            "change_gap": (worst(change(p_after), change(r_after), kept),
                           lim["change_gap"]),
            "ema_gap": (worst(change(p_ema), change(r_ema), kept),
                        lim["ema_gap"])}
