"""Public pipeline API of the port: shape-conditioned molecule generation.

Twin of ``ml_conformer_generator_tpu/generator.py`` (reference
``conformer_generator.py`` ``MLConformerGenerator`` :19-399), with the same
constructor and ``generate_conformers`` signature. Differences: ``device``
replaces ``use_pallas`` (default ``"cuda"``; the constructor raises when
there is no CUDA device and the caller did not ask for the CPU) and
``dtype`` is a torch dtype.

Stages: the sampler (plain generation, or with a ``fixed_fragment`` either
inpainting or inertial fragment matching) runs the EGNN on the device, its
edge passes in the CUDA kernel of ``ops/gcl_kernel.py``; featurisation and
chemistry run on the host; the bond predictor and the force field run on
the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .checkpoint import (load_jax_params, load_onnx_adj_mat_seer,
                         load_onnx_edm, load_torch_adj_mat_seer,
                         load_torch_edm, save_params, to_jax_params)
from .chem.bonds import redefine_bonds
from .chem.featurize import (fragment_to_xh, prepare_adj_mat_seer_input,
                             samples_to_molecules)
from .chem.mol import Molecule
from .chem.standardize import standardize_batch
from .config import (ATOM_DECODER, CONTEXT_NORMS, DIMENSION, MAX_N_NODES,
                     MIN_N_NODES, NUM_BOND_TYPES, AdjMatSeerConfig,
                     DiffusionConfig, EGNNConfig)
from .diffusion.edm import EDMSampler
from .diffusion.schedule import gamma_schedule
from .models.adj_mat_seer import AdjMatSeer, predict_bond_types
from .models.egnn import EGNNDynamics
from .ops.moi import get_context_shape, inverse_coord_transform
from .utils.device import resolve_device
from .utils.fragments import (ifm_prepare_fragments_for_merge,
                              ifm_prepare_gen_fragment_context,
                              prepare_fragment)
from .utils.masks import pad_to_bucket, prepare_edm_input
from .utils.metrics import StageTimer, span, spanned

__all__ = ["MLConformerGenerator", "MLConformerGeneratorONNX",
           "resolve_device"]


class MLConformerGenerator:
    """Generates novel molecules matching the 3D shape of a reference.

    Weights: ``edm_weights`` / ``adj_mat_seer_weights`` as the JAX package's
    ``.npz`` checkpoints, the reference's ONNX artifacts (``.onnx``) or its
    torch ``.pt`` files, dispatched on the suffix. Without weight files the
    models are randomly initialised from ``seed`` (useful only for pipeline
    testing).
    """

    def __init__(
        self,
        diffusion_steps: int = 100,
        dimension: int = DIMENSION,
        num_bond_types: int = NUM_BOND_TYPES,
        min_n_nodes: int = MIN_N_NODES,
        max_n_nodes: int = MAX_N_NODES,
        context_norms: Dict = CONTEXT_NORMS,
        atom_decoder: Dict[int, str] = ATOM_DECODER,
        edm_weights: Optional[str] = None,
        adj_mat_seer_weights: Optional[str] = None,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
        compute_dtype: str = "bfloat16",
        node_bucket: int = 8,
        compile_cache_dir: Optional[str] = None,
        device=None,
    ):
        if compile_cache_dir:
            # the kernel libraries are built into and loaded from here
            # (utils/cache.py)
            from .utils.cache import enable_compile_cache
            enable_compile_cache(compile_cache_dir)
        self.device = resolve_device(device)
        self.dtype = dtype
        self.dimension = dimension
        self.context_norms = context_norms
        self.atom_decoder = atom_decoder
        self.min_n_nodes = min_n_nodes
        self.max_n_nodes = max_n_nodes
        self.diffusion_steps = diffusion_steps
        #: node-axis padding granularity (the sampler's shape changes per
        #: bucket only)
        self.node_bucket = node_bucket

        self.egnn_cfg = EGNNConfig(in_node_nf=9, context_node_nf=3,
                                   hidden_nf=420, compute_dtype=compute_dtype)
        self.diff_cfg = DiffusionConfig(timesteps=diffusion_steps,
                                        noise_precision=1e-5)
        self.adj_cfg = AdjMatSeerConfig(dimension=dimension, n_hidden=2048,
                                        embedding_dim=64, num_embeddings=36,
                                        num_bond_types=num_bond_types)

        init_gen = torch.Generator().manual_seed(seed)
        dynamics = EGNNDynamics(self.egnn_cfg, init_gen)
        self.adj_model = AdjMatSeer(self.adj_cfg, init_gen)
        if edm_weights is not None:
            self._load(edm_weights, dynamics, load_torch_edm, load_onnx_edm)
        if adj_mat_seer_weights is not None:
            self._load(adj_mat_seer_weights, self.adj_model,
                       load_torch_adj_mat_seer, load_onnx_adj_mat_seer)
        #: the float32 denoiser weights as a JAX-layout numpy tree, kept
        #: before the cast below so that :meth:`save_weights` writes them
        #: and not their bf16 rounding
        self.edm_params = to_jax_params(dynamics)
        # bf16 feature path: the denoiser's parameters are cast once, here
        cd = torch.bfloat16 if compute_dtype == "bfloat16" else dtype
        dynamics = dynamics.to(device=self.device, dtype=cd).eval()
        self.adj_model = self.adj_model.to(device=self.device,
                                           dtype=dtype).eval()

        # Rebuilt schedule for the requested step count (reference :104-113);
        # a host-side table, the sampler reads its scalars per step.
        self.gamma = torch.from_numpy(gamma_schedule(diffusion_steps,
                                                     precision=1e-5))
        self.sampler = EDMSampler(dynamics, self.diff_cfg)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)

    @staticmethod
    def _load(path: str, module, torch_loader, onnx_loader) -> None:
        if path.endswith(".npz"):
            load_jax_params(path, module)
        elif path.endswith(".onnx"):
            onnx_loader(path, module)
        else:
            torch_loader(path, module)

    # ------------------------------------------------------------------
    # Sampling stage (reference edm_samples :125-266)
    # ------------------------------------------------------------------

    def edm_samples(
        self,
        reference_context,
        n_samples: int = 100,
        max_n_nodes: int = 32,
        min_n_nodes: int = 25,
        resample_steps: int = 0,
        fixed_fragment: Optional[Molecule] = None,
        inertial_fragment_matching: bool = True,
        blend_power: int = 3,
        ifm_diffusion_level: int = 50,
    ) -> List[Molecule]:
        """Run the diffusion stage; returns bond-less molecules.

        Routing as in the reference: plain generation; with
        ``fixed_fragment``, inertial fragment matching
        (``inertial_fragment_matching``) or inpainting.
        """
        with span("mlcg.sample.prelude"):
            min_n_nodes = max(min_n_nodes, self.min_n_nodes)
            max_n_nodes = min(max_n_nodes, self.max_n_nodes)
            n_pad = pad_to_bucket(max_n_nodes, self.node_bucket)
            # a float32 context, as the JAX package holds it
            reference_context = torch.as_tensor(
                reference_context, dtype=torch.float32, device=self.device)

            node_mask, edge_mask, batch_context, n_nodes = prepare_edm_input(
                self._generator, n_samples, reference_context,
                self.context_norms, min_n_nodes, max_n_nodes,
                n_nodes_pad=n_pad, device=self.device)

        if fixed_fragment is None:
            x, h = self.sampler.generate(
                self._generator, self.gamma, node_mask, edge_mask,
                batch_context, resample_steps=resample_steps, dtype=self.dtype)
        elif inertial_fragment_matching:
            x, h = self._ifm_samples(
                reference_context, node_mask, edge_mask, batch_context,
                n_nodes, fixed_fragment, n_pad, min_n_nodes,
                resample_steps, blend_power, ifm_diffusion_level)
        else:
            with span("mlcg.sample.prelude"):
                frag_x, frag_h = self._fragment_tensors(fixed_fragment)
                z_known, fixed_mask = prepare_fragment(
                    n_samples, frag_x, frag_h, n_pad, min_n_nodes)
            x, h = self.sampler.inpaint(
                self._generator, self.gamma, node_mask, edge_mask,
                batch_context, z_known, fixed_mask,
                resample_steps=resample_steps, blend_power=blend_power,
                dtype=self.dtype)
        # the host waits here for the trajectory to end, then copies
        with span("mlcg.sample.to_host"):
            x, h = x.cpu().numpy(), h.cpu().numpy()
            node_mask = node_mask.cpu().numpy()
        with span("mlcg.sample.decode"):
            return samples_to_molecules(x, h, node_mask, self.atom_decoder)

    def _fragment_tensors(self, fixed_fragment: Molecule):
        frag_x, frag_h = fragment_to_xh(fixed_fragment)
        return (torch.as_tensor(frag_x, device=self.device),
                torch.as_tensor(frag_h, device=self.device))

    def _ifm_samples(self, reference_context, node_mask, edge_mask,
                     batch_context, n_nodes, fixed_fragment, max_n_nodes,
                     min_n_nodes, resample_steps, blend_power,
                     ifm_diffusion_level):
        """Inertial fragment matching (reference :179-241).

        Generate the complement fragments in their own principal frames, rotate
        them back, then merge with the fixed fragment by partial re-diffusion.
        """
        with span("mlcg.sample.prelude"):
            frag_x, frag_h = self._fragment_tensors(fixed_fragment)
            (frag_node_mask, frag_edge_mask, frag_context, shift,
             rotation) = ifm_prepare_gen_fragment_context(
                frag_x, reference_context, self.context_norms, n_nodes,
                max_n_nodes, min_n_nodes)

        x_gen, h_gen = self.sampler.generate(
            self._generator, self.gamma, frag_node_mask, frag_edge_mask,
            frag_context, resample_steps=resample_steps, dtype=self.dtype)
        with span("mlcg.sample.prelude"):
            x_gen = inverse_coord_transform(x_gen, shift, rotation)
            z_known, fixed_mask = ifm_prepare_fragments_for_merge(
                frag_x, frag_h, x_gen, h_gen, max_n_nodes)
        return self.sampler.merge_fragments(
            self._generator, self.gamma, node_mask, edge_mask, fixed_mask,
            batch_context, z_known, diffusion_level=ifm_diffusion_level,
            resample_steps=resample_steps, blend_power=blend_power,
            dtype=self.dtype)

    # ------------------------------------------------------------------
    # Full pipeline (reference generate_conformers :268-368)
    # ------------------------------------------------------------------

    @spanned("mlcg.request")
    def generate_conformers(
        self,
        reference_conformer: Optional[Molecule] = None,
        n_samples: int = 10,
        variance: int = 2,
        reference_context=None,
        n_atoms: Optional[int] = None,
        optimise_geometry: bool = True,
        resample_steps: int = 0,
        fixed_fragment: Optional[Molecule] = None,
        inertial_fragment_matching: bool = True,
        blend_power: int = 3,
        ifm_diffusion_level: int = 50,
    ) -> List[Molecule]:
        """Generate valid, standardised molecules matching a reference shape.

        Same signature and routing as the reference
        (``conformer_generator.py:268-368``).
        """
        if reference_conformer is not None:
            ref = reference_conformer.remove_hs()
            ref_n_atoms = ref.num_atoms
            coords = np.asarray(ref.coords, dtype=np.float32)
            coords = coords - coords.mean(axis=0)
            ref_context, _ = get_context_shape(coords)
        elif reference_context is not None:
            if not n_atoms:
                raise ValueError(
                    "Reference Number of Atoms should be provided, when "
                    "generating samples using context.")
            ref_n_atoms = n_atoms
            ref_context = reference_context
        else:
            raise ValueError(
                "Either a reference Molecule or context should be provided "
                "for generation.")

        timer = StageTimer()
        with timer.stage("edm_sampling"):
            raw = self.edm_samples(
                reference_context=ref_context,
                n_samples=n_samples,
                min_n_nodes=ref_n_atoms - variance,
                max_n_nodes=ref_n_atoms + variance,
                resample_steps=resample_steps,
                fixed_fragment=fixed_fragment,
                inertial_fragment_matching=inertial_fragment_matching,
                blend_power=blend_power,
                ifm_diffusion_level=ifm_diffusion_level,
            )

        with timer.stage("featurize"):
            elements, dist, adj, canon = prepare_adj_mat_seer_input(
                raw, self.dimension)

        with timer.stage("bond_prediction"):
            # (B, D, D) int8 bond types, argmax-decoded on the device
            dev, dt = self.device, self.dtype
            adj_types = predict_bond_types(
                self.adj_model, torch.as_tensor(elements, device=dev),
                torch.as_tensor(dist, device=dev, dtype=dt),
                torch.as_tensor(adj, device=dev, dtype=dt)).cpu().numpy()

        with timer.stage("standardize"):
            bonded = [redefine_bonds(canon[i], adj_types[i])
                      for i in range(len(canon))]
            standardized = standardize_batch(bonded, optimise_geometry,
                                             device=self.device)
        valid = [m for m in standardized if m is not None]
        timer.count("requested", n_samples)
        timer.count("valid", len(valid))
        #: per-stage latency + yield of the most recent request
        self.last_metrics = timer.summary()
        return valid

    #: reference parity: ``forward`` aliases the full pipeline
    #: (``conformer_generator.py:370-399``), as does calling the instance.
    forward = generate_conformers
    __call__ = generate_conformers

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    def save_weights(self, edm_path: str, adj_path: str) -> None:
        """Write both models as the JAX package's ``.npz`` checkpoints: the
        float32 denoiser weights the sampler's module was cast from
        (:attr:`edm_params`) and the bond predictor as it is held."""
        save_params(edm_path, self.edm_params)
        save_params(adj_path, to_jax_params(self.adj_model))


class MLConformerGeneratorONNX(MLConformerGenerator):
    """Drop-in analog of the reference's torch-free ONNX runtime class.

    The reference ships a second, numpy+onnxruntime implementation of the
    whole pipeline (``conformer_generator_onnx.py:18-73``) so users can run
    inference from the ``.onnx`` weight artifacts. This class keeps the
    reference's constructor shape: it takes the same ``egnn_onnx`` /
    ``adj_mat_seer_onnx`` paths, pulls the initializer tensors straight out
    of the ONNX protobufs (``onnx_weights.py``, no onnx/onnxruntime
    dependency) and runs the port's pipeline on ``device`` as the parent
    class does. The reference numpy port's uniform-vs-gaussian
    position-noise bug (``equivariant_diffusion_onnx.py:52``) is
    deliberately not replicated.
    """

    def __init__(
        self,
        diffusion_steps: int = 100,
        dimension: int = DIMENSION,
        min_n_nodes: int = MIN_N_NODES,
        max_n_nodes: int = MAX_N_NODES,
        context_norms: Dict = CONTEXT_NORMS,
        atom_decoder: Dict[int, str] = ATOM_DECODER,
        egnn_onnx: str = "./egnn_chembl_15_39.onnx",
        adj_mat_seer_onnx: str = "./adj_mat_seer_chembl_15_39.onnx",
        **kwargs,
    ):
        # The parent dispatches loaders on the path suffix; a non-.onnx path
        # here would silently fall through to the torch .pt loader with a
        # confusing error, so fail fast with a clear message.
        for name, path in (("egnn_onnx", egnn_onnx),
                           ("adj_mat_seer_onnx", adj_mat_seer_onnx)):
            if not str(path).endswith(".onnx"):
                raise ValueError(
                    f"MLConformerGeneratorONNX expects {name} to be a .onnx "
                    f"file, got {path!r}")
        super().__init__(
            diffusion_steps=diffusion_steps,
            dimension=dimension,
            min_n_nodes=min_n_nodes,
            max_n_nodes=max_n_nodes,
            context_norms=context_norms,
            atom_decoder=atom_decoder,
            edm_weights=egnn_onnx,
            adj_mat_seer_weights=adj_mat_seer_onnx,
            **kwargs,
        )
