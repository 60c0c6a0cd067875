"""mfu.train: share (%) of the configuration's peak of the model
operations of the window's train steps (three times the forward at each
molecule's real atom count; ``flops.train_step_flops``) over the window's
seconds."""

from benchmark import flops, layers


def read(run):
    return layers.mfu(run, flops.train_step_flops)
