"""train_mol_per_s: molecules of every train step of the window (each
with its EMA update), over the window's seconds, which end when the
device has finished the last step."""


def read(run):
    done = run.done()
    if not done or run.window_s <= 0:
        return None
    return sum(u["molecules"] for u in done) / run.window_s
