"""Training traffic of EDM GEOM-Drugs: the train step and the EMA update on
every step, driven as ``training.loop.train`` drives them, on all-atom
batches that the program's data pipeline (``training.AllAtomDataset``)
pads each to its own largest molecule, rounded up to the node bucket.

The corpus is ``drugs_train.corpus``'s: in each batch one molecule of 96,
128, 144 or 181 atoms (the sizes cycled in the seed's order), the others
of drug-like size; so the steps come in four shapes, padded to 96, 128,
144 and 184 nodes. Set-up builds one training object, the denoiser with
the benchmark's weights (``drugs.make_weights``), its AdamW state and
``make_train_step``'s step on the one-device mesh, and its moving average;
it drives that object through its first ``judge_steps`` steps, two cycles
of the four shapes, through the same call and feed as the window: the
first cycle's steps run eagerly as the captures' warm-ups (each captures
that shape's step graph; the first also the average's), the second
cycle's are replays of the four graphs that share one memory pool, as
every step of the window is. The weights before each judged step and
after the last, each step's loss and gradients, and the average after
them are kept. The window goes on with the same object and captures
nothing.

The reference (``reference/train_drugs.py``) takes the same steps on the
same batches and draws, in blocks of molecules, each from the program's
weights before that step (``run_steps``' ``forced``): two runs of this
denoiser that differ by round-off drift apart within a few steps (the
gradients at the same step of two free runs differ by up to 5e-3 by the
eighth step, PERF.md §2), so each step is held against the reference from
where the program stood. At each step ``train.compare``'s readings: the
loss (``loss_gap``), and by the worst leaf the gradient (``grad_gap``:
each pad's backward, eager and replayed, on every seed) and the step's
change of the weights (``change_gap``: the program's update against
AdamW's from the same weights, with the reference's own moments); the
worst step's are kept. The precision hardly moves these numbers: at an
ill-conditioned step (after the first update the benchmark's weights can
read a loss of 100) the float32 program's gradient lies as far from the
reference as one with TF32 products does (PERF.md §2), so the gradient's
and the change's limits lie between the program's readings and 1, what a
step that changed nothing reads; the loss's lies below the planted
faults'. The average after the judged steps is compared by its change
from the first weights (``ema_gap``: the reference's average over the
program's weights).

``control``: the reference in the configuration's control format (TF32
products) in the program's place for the judged steps; the window's units
then do no work.
"""

from __future__ import annotations

import copy

from .. import drugs, drugs_train
from ..traffic import derive_seed
from . import common, train


class Driver(train.Driver):
    def __init__(self, run):
        super().__init__(run)
        self.control = run.control

    def _feed(self):
        """The corpus's batches in order, cycled, featurised by the
        program's all-atom pipeline."""
        k = 0
        while True:
            yield self.dataset.featurize(self.batch_idx[k % len(
                self.batch_idx)])
            k += 1

    def setup(self):
        import torch
        from ml_conformer_generator_tpu_torch.chem.mol import Molecule
        from ml_conformer_generator_tpu_torch.config import (DiffusionConfig,
                                                             EGNNConfig)
        from ml_conformer_generator_tpu_torch.diffusion.schedule import (
            gamma_schedule)
        from ml_conformer_generator_tpu_torch.models.egnn import EGNNDynamics
        from ml_conformer_generator_tpu_torch.ops import gcl_kernel
        from ml_conformer_generator_tpu_torch.parallel import make_mesh
        from ml_conformer_generator_tpu_torch.training import (
            AllAtomDataset, prefetch)
        from ml_conformer_generator_tpu_torch.training.loop import ema_update_
        from ml_conformer_generator_tpu_torch.training.step import (
            init_train_state, make_optimizer, make_train_step)

        run, cfg, wl = self.run, self.cfg, self.wl
        dev = run.device
        self.torch, self.ema_update_, self.gk = torch, ema_update_, gcl_kernel
        self.w0 = drugs.make_weights(cfg, derive_seed(run.seed, 10), dev)
        self.corpus = drugs_train.corpus(wl, run.seed)
        if self.control:
            self._control()
            return
        if dev == "cuda":
            common.enable_kernel_cache()
        egnn_cfg = EGNNConfig(
            in_node_nf=cfg["in_node_nf"],
            context_node_nf=cfg["context_node_nf"],
            hidden_nf=cfg["hidden_nf"], n_blocks=cfg["n_blocks"],
            edge_feat_nf=cfg["edge_feat_nf"],
            normalization_factor=cfg["normalization_factor"],
            compute_dtype=cfg["compute_dtype"],
            inv_sublayers=cfg["inv_sublayers"],
            norm_constant=cfg["norm_constant"],
            coords_range=cfg["coords_range"])
        diff_cfg = DiffusionConfig(
            timesteps=cfg["timesteps"], noise_precision=cfg["noise_precision"],
            in_node_nf=len(cfg["atom_decoder"]),
            norm_values=tuple(cfg["norm_values"][:2]),
            schedule_power=cfg["schedule_power"])
        with torch.device(dev):
            model = EGNNDynamics(egnn_cfg)
        model.load_state_dict(self.w0)
        self.model = model
        self.state = init_train_state(model, make_optimizer(
            lr=wl["lr"], weight_decay=wl["weight_decay"]))
        mols = [Molecule(z, pos, []) for b in self.corpus for z, pos in b]
        self.dataset = AllAtomDataset(
            mols, atom_decoder=dict(enumerate(cfg["atom_decoder"])),
            max_n_nodes=cfg["max_n_nodes"], node_bucket=cfg["node_bucket"])
        if len(self.dataset) != len(mols):
            raise ValueError("the program's dataset dropped corpus molecules")
        self.step = make_train_step(make_mesh(device=dev), egnn_cfg,
                                    diff_cfg,
                                    batch_shapes=self.dataset.batch_shapes)
        self.ema = copy.deepcopy(model).requires_grad_(False)
        self.gamma = torch.as_tensor(gamma_schedule(
            cfg["timesteps"], cfg["noise_precision"], cfg["schedule_power"]),
            dtype=torch.float32)
        self.generator = torch.Generator(device=dev).manual_seed(
            derive_seed(run.seed, 12))
        B = wl["batch"]
        self.batch_idx = [list(range(k * B, (k + 1) * B))
                          for k in range(len(self.corpus))]
        self.feed = prefetch(self._feed(), depth=wl["prefetch"])
        self.count = 0
        self.losses, self.grads = [], []
        # the weights before each judged step and after the last
        self.weights = [self.w0]
        for _ in range(wl["judge_steps"]):
            metrics = self._step()
            self.losses.append(metrics["loss"])
            # the step's gradients (a captured step's are in its graph's
            # memory, where ``.grad`` points after the call)
            self.grads.append({
                n: p.grad.detach().clone() if p.grad is not None
                else torch.zeros_like(p)
                for n, p in model.named_parameters()})
            self.weights.append({n: p.detach().clone()
                                 for n, p in model.state_dict().items()})
        self.ema_after = {n: p.detach().clone()
                          for n, p in self.ema.named_parameters()}

    def _control(self):
        """The judged steps by the reference in the control's format."""
        got = reference_steps(self.cfg, self.wl, self.run.seed,
                              self.run.device, self.control[0],
                              corpus=self.corpus)
        self.losses, self.grads, weights, self.ema_after = got
        self.weights = [self.w0] + weights

    def _step(self):
        batch = next(self.feed)
        metrics = self.step(self.model, self.state, self.generator, batch,
                            self.gamma)
        self.ema_update_(self.ema, self.model, self.wl["ema_decay"],
                         self.count)
        self.count += 1
        self.last_atoms = batch["node_mask"].sum(axis=(1, 2))
        self.last_shape = batch["x"].shape[:2]
        return metrics

    def unit(self, i):
        if self.control:
            return {"molecules": 0, "atoms": [], "shape": None}
        before = dict(self.gk.LAUNCHES)
        self._step()
        after = self.gk.LAUNCHES
        return {"molecules": self.wl["batch"],
                "atoms": self.last_atoms.astype(int).tolist(),
                "shape": tuple(int(n) for n in self.last_shape),
                "launches": {k: after[k] - before.get(k, 0) for k in after}}

    def finish(self):
        self.sync()
        self.losses = [float(x) for x in self.losses]
        graphs = getattr(getattr(self, "step", None), "graphs", None)
        if graphs is not None:
            # the step's graph captures by padded nodes (set-up and window)
            by_n = {}
            for key, n in graphs.captures_by_key.items():
                N = {k: shape for k, shape, _ in key[2]}["x"][1]
                by_n[N] = by_n.get(N, 0) + n
            self.run.info["step_captures_by_nodes"] = {
                str(k): v for k, v in sorted(by_n.items())}

    def release(self):
        if self.control:
            return
        super().release()

    def judge(self):
        ref = reference_steps(self.cfg, self.wl, self.run.seed,
                              self.run.device, "float32", self.corpus,
                              self.weights)
        return compare((self.losses, self.grads, self.weights[1:],
                        self.ema_after), ref, self.weights,
                       lim=self.run.workload["limits"], info=self.run.info)


def compare(prog, ref, starts, *, lim, info):
    """The cell's checks. ``prog``, ``ref``: (losses, each step's
    gradients, the weights after each step, average after) of the program
    and of the reference, forced to the program's weights ``starts``
    (before each step and after the last). At each step ``train.compare``'s
    readings of the program against the reference, from the program's
    weights before the step; the worst step's kept, each step's going to
    ``info``. The average's change from the first step's.
    {name: (value, limit)}."""
    keys = ("loss_gap", "grad_gap", "change_gap", "ema_gap")
    any_lim = dict.fromkeys(keys, 0.0)
    p = [{k: v[0] for k, v in train.compare(
        [prog[0][s]], prog[1][s], prog[2][s], prog[3], [ref[0][s]],
        ref[1][s], ref[2][s], ref[3], w0=starts[s], lim=any_lim).items()}
        for s in range(len(prog[1]))]
    for k in keys[:3]:
        info[f"{k}_by_step"] = [g[k] for g in p]
    out = {k: (max(g[k] for g in p), lim[k]) for k in keys[:3]}
    out["ema_gap"] = (p[0]["ema_gap"], lim["ema_gap"])
    return out


def reference_steps(cfg, wl, seed, device, fmt="float32", corpus=None,
                    forced=None):
    """The plain reference's first ``judge_steps`` steps of a run of
    ``seed``: (losses, each step's gradients, the weights after each step,
    average after), with TF32 off, in blocks of ``reference_rows``
    molecules. ``fmt``: the products' format (a control's); ``forced``:
    the weights each step starts from (``run_steps``')."""
    import torch

    from ..reference import train_drugs
    from ..reference.precision import exact_float32

    corpus = corpus if corpus is not None else drugs_train.corpus(wl, seed)
    # the corpus's batches in order, cycled, as the program's feed takes
    # them
    batches = [train_drugs.featurize(corpus[k % len(corpus)], cfg, device)
               for k in range(wl["judge_steps"])]
    w0 = drugs.make_weights(cfg, derive_seed(seed, 10), device)
    g = torch.Generator(device=device).manual_seed(derive_seed(seed, 12))
    with exact_float32():
        return train_drugs.run_steps(w0, cfg, batches, g, wl["judge_steps"],
                                     wl["lr"], wl["weight_decay"],
                                     wl["ema_decay"], fmt,
                                     wl["reference_rows"], forced)
