"""What the metric readers of ``metrics/`` share: the window's means of a
request's stages, the edge kernels' share of their roofline from the
trace, the share of the peak, the device's idle share. Each returns None
where its run holds nothing to read."""

from __future__ import annotations

import statistics

from . import devtrace, flops


def mean_stage_ms(run, *stages):
    """Mean over the window's requests of the sum of ``stages`` of the
    generator's ``last_metrics`` (host seconds), in ms."""
    done = [u for u in run.done() if "stages" in u]
    if not done:
        return None
    return 1e3 * statistics.fmean(sum(u["stages"][f"{s}_s"] for s in stages)
                                  for u in done)


def edge_roofline(run, kinds, with_product=False):
    """100 x (the least seconds of every traced launch of the edge kernels
    ``kinds`` at its shape) / (their device seconds). The shape is the
    traced unit's (``shape``: graphs, nodes). ``with_product``: the
    backward's bound covers its dW1 product too, a library GEMM launched
    after each backward kernel, whose time is added."""
    tr = run.trace
    if tr is None or not tr.units:
        return None
    cfg = run.config
    H, E = cfg["hidden_nf"], cfg["edge_feat_nf"]
    shapes = [u.get("shape") for u in run.traced_units]
    if None in shapes or len(shapes) != len(tr.units):
        return None
    if len(set(map(tuple, shapes))) == 1:
        # one shape throughout (train steps, which the device runs after
        # the host returns): every event of the traced window
        groups = [(tr.in_window(), shapes[0])]
    else:
        # requests end on the host after their device work: by unit
        groups = [(tr.unit_events(k), sh) for k, sh in enumerate(shapes)]
    bound = seconds = 0.0
    for events, (B, N) in groups:
        pending = False
        for name, s, e in sorted(events, key=lambda d: d[1]):
            kind = devtrace.edge_kernel(name)
            if kind is None:
                if pending and devtrace.categorize(name) == "matmul (GEMM)":
                    seconds += e - s
                    pending = False
                continue
            pending = False
            if kind[0] not in kinds:
                continue
            back = kind[0] == "bwd_f32"
            bound += flops.edge_pass_bound(
                B, N, H, E, cfg["compute_dtype"], kind[1], backward=back)[0]
            seconds += e - s
            pending = with_product and back
    if seconds <= 0:
        return None
    return 100.0 * bound / seconds


def mfu(run, unit_flops):
    """100 x the model operations of the window's units / (window seconds
    x the configuration's peak)."""
    done = run.done()
    if not done or run.window_s <= 0:
        return None
    ops = sum(unit_flops(run.config, u["atoms"]) for u in done)
    return 100.0 * ops / (run.window_s
                          * flops.PEAK_OPS[run.config["compute_dtype"]])


def idle(run):
    """100 x (1 - device busy seconds / traced window seconds)."""
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
