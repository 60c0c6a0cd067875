"""What both drivers share: the program's configurations built from a
configuration file, its kernel cache, and the benchmark's weights."""

from __future__ import annotations

import os

from ..harness import CACHE
from ..traffic import derive_seed
from ..weights import make_weights


def enable_kernel_cache() -> None:
    """The port's kernel libraries built into, and loaded from, a fixed
    directory of the checkout (the port's public switch)."""
    from ml_conformer_generator_tpu_torch import enable_compile_cache

    enable_compile_cache(os.path.join(CACHE, "kernels"))


def egnn_config(cfg):
    from ml_conformer_generator_tpu_torch.config import EGNNConfig

    return EGNNConfig(in_node_nf=cfg["in_node_nf"],
                      context_node_nf=cfg["context_node_nf"],
                      hidden_nf=cfg["hidden_nf"], n_blocks=cfg["n_blocks"],
                      edge_feat_nf=cfg["edge_feat_nf"],
                      normalization_factor=cfg["normalization_factor"],
                      compute_dtype=cfg["compute_dtype"])


def diffusion_config(cfg):
    from ml_conformer_generator_tpu_torch.config import DiffusionConfig

    return DiffusionConfig(timesteps=cfg["timesteps"],
                           noise_precision=cfg["noise_precision"],
                           schedule_power=cfg["schedule_power"],
                           norm_values=tuple(cfg["norm_values"]))


def weights(run):
    """The run's weights (EGNN, bond predictor), float32 on its device."""
    return make_weights(run.config, derive_seed(run.seed, 10), run.device)
