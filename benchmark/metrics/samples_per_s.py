"""samples_per_s: raw samples of every request the window completed, over
the window's seconds (its start to the end of the request in flight when
``--seconds`` had passed). Raw: with random weights no sample survives
standardisation, and that is the model's output, not a failure."""


def read(run):
    done = run.done()
    if not done or run.window_s <= 0:
        return None
    return sum(u["samples"] for u in done) / run.window_s
