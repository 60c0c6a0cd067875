"""Training of the port: the EDM denoiser (loss, AdamW step, loop with EMA
and checkpoints) and the bond predictor, their data pipeline and the
perturb-and-relax augmentation. On the card every edge pass of the
denoiser, forward and backward, runs in the port's float32 kernels."""

from .augment import perturb_and_relax
from .bonds import bond_training_batch, train_adj_mat_seer
from .data import AllAtomDataset, MoleculeDataset, batches, prefetch
from .loop import train
from .loss import edm_training_loss
from .step import init_train_state, make_optimizer, make_train_step
