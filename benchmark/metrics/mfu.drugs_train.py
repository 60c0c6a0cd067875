"""mfu.drugs_train: share (%) of the configuration's float32 peak (3xTF32,
as ``mfu.train``) of the model operations of the window's train steps:
three times the denoiser's forward at each molecule's real atom count
(``drugs.forward_flops``), over the window's seconds."""

from benchmark import drugs, layers


def read(run):
    return layers.mfu(run, lambda cfg, atoms: 3 * sum(
        drugs.forward_flops(cfg, n) for n in atoms))
