"""The yardstick's arithmetic on fixed inputs: the kernels' bounds, the
model operations, the union of device intervals, the breakdown, the tail
and the rates."""

import math
import types

import pytest

from benchmark import devtrace, flops, harness

CFG = dict(hidden_nf=420, edge_feat_nf=2, in_node_nf=9, context_node_nf=3,
           n_blocks=9, timesteps=100, dimension=42, n_hidden=2048,
           embedding_dim=64, num_bond_types=5, compute_dtype="bfloat16")


@pytest.mark.parametrize("args,ms,by", [
    # the bounds of the kernel table in PERF.md (chip_smoke.py's numbers)
    ((64, 32, 420, 2, "bfloat16", "gcl"), 0.0235, "operations"),
    ((64, 32, 420, 2, "float32", "gcl"), 0.1411, "operations"),
    ((128, 40, 420, 2, "float32", "coord"), 0.4410, "operations"),
    ((5, 40, 420, 2, "bfloat16", "gcl"), 0.00287, "operations"),
])
def test_edge_pass_bound_forward(args, ms, by):
    s, what = flops.edge_pass_bound(*args)
    assert s * 1e3 == pytest.approx(ms, rel=2e-3) and what == by


def test_edge_pass_bound_backward():
    s, what = flops.edge_pass_bound(64, 39, 420, 2, "float32", "gcl",
                                    backward=True)
    assert s * 1e3 == pytest.approx(0.6244, rel=2e-3)
    assert what == "operations"
    assert s == pytest.approx(3 * 2 * 64 * 39 ** 2 * 420 ** 2
                              / (495e12 / 3))


def test_model_operations():
    H, E, n = 420, 2, 27
    edge = 3 * 2 * n * (n - 1) * H * (H + E + 1)
    node = 6 * 2 * n * H * H + 2 * (2 * n * 2 * H * H + 2 * n * H * H)
    fwd = 9 * (edge + node) + 2 * 2 * n * 12 * H
    assert flops.egnn_forward_flops(CFG, n) == pytest.approx(fwd)
    req = flops.request_flops(CFG, [n, n])
    assert req == pytest.approx(101 * 2 * fwd + flops.adj_mat_seer_flops(
        CFG, 2))
    assert flops.train_step_flops(CFG, [n]) == pytest.approx(3 * fwd)
    # a single atom has no edge
    assert flops.egnn_forward_flops(CFG, 1) < flops.egnn_forward_flops(
        CFG, 2) / 2


def _trace():
    dev = [("void edge_mlp_bf16_kernel<true>(int, int)", 0.10, 0.20),
           ("void edge_mlp_bf16_kernel<false>(int, int)", 0.15, 0.30),
           ("sm90_xmma_gemm_f32", 0.50, 0.60),
           ("Memcpy HtoD", 0.90, 1.20)]
    host = [("bench.unit", 0.0, 0.7), ("aten::item", 0.28, 0.45),
            ("bench.unit", 0.7, 1.1)]
    return devtrace.Trace(dev, host, (0.0, 1.0), [(0.0, 0.7), (0.7, 1.0)])


def test_busy_union_and_breakdown():
    tr = _trace()
    # [0.10, 0.30] + [0.50, 0.60] + [0.90, 1.00] (clipped to the window)
    assert tr.busy_s() == pytest.approx(0.4)
    assert tr.window_s == pytest.approx(1.0)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["edge_mlp_bf16_kernel<false>",
                                  pytest.approx(0.15)]
    gaps = {round(d, 6): name for name, d in b["idle_gaps"]}
    assert gaps[0.2] == "aten::item"          # 0.30 -> 0.50
    assert gaps[0.1] == "bench.unit"          # 0.00 -> 0.10
    assert devtrace.edge_kernel(_trace().device[1][0]) == ("bf16", "coord")
    assert devtrace.edge_kernel("edge_mlp_bwd_f32_kernel<true, 2>") == (
        "bwd_f32", "gcl")
    assert devtrace.edge_kernel("sm90_xmma_gemm") is None


def _run(units, window=(0.0, 10.0), trace=None, cfg=CFG):
    spec = types.SimpleNamespace(config=cfg, workload={}, cell={"chips": 1},
                                 per_layer=[], end_to_end=[])
    run = harness.Run(spec, 1, 10.0, trace is not None, "cpu", 0.0)
    run.units, run.window, run.trace = units, window, trace
    if trace is not None:
        run.traced_units = units[:len(trace.units)]
    return run


def test_rates_tail_and_shares():
    spec = harness.Spec("sample-bf16-interactive")
    units = [{"start": 0.1 * i, "end": 0.1 * i + (1.0 if i == 7 else 0.1),
              "samples": 10, "atoms": [20] * 10,
              "stages": {"edm_sampling_s": 0.05, "featurize_s": 0.01,
                         "standardize_s": 0.02, "bond_prediction_s": 0.003},
              "shape": (10, 24)} for i in range(20)]
    run = _run(units)
    assert spec.reader("samples_per_s").read(run) == pytest.approx(20.0)
    # nearest rank of 20: the 19th smallest
    assert spec.reader("request_p95_s").read(run) == pytest.approx(0.1)
    units[3]["error"] = "boom"
    assert spec.reader("request_p95_s").read(run) == pytest.approx(1.0)
    units[4]["error"] = "boom"
    assert math.isinf(spec.reader("request_p95_s").read(run))
    del units[3]["error"], units[4]["error"]
    assert spec.reader("sampling_ms").read(run) == pytest.approx(50.0)
    assert spec.reader("host_chem_ms").read(run) == pytest.approx(30.0)
    mfu = spec.reader("mfu.sample").read(run)
    assert mfu == pytest.approx(100 * 20 * flops.request_flops(
        CFG, [20] * 10) / (10.0 * 989e12))
    tr = _trace()
    run = _run(units[:2], trace=tr)
    assert spec.reader("device_idle.sample").read(run) == pytest.approx(60.0)
    roof = spec.reader("edge_fwd_roofline.sample").read(run)
    bound = (flops.edge_pass_bound(10, 24, 420, 2, "bfloat16", "gcl")[0]
             + flops.edge_pass_bound(10, 24, 420, 2, "bfloat16", "coord")[0])
    assert roof == pytest.approx(100 * bound / 0.25)
    # nothing to read: no value, never 0
    assert spec.reader("edge_fwd_roofline.sample").read(_run(units)) is None


def test_backward_share_takes_its_product():
    spec = harness.Spec("train-f32-b64")
    cfg = dict(CFG, compute_dtype="float32")
    dev = [("edge_mlp_bwd_f32_kernel<true, 2>", 0.0, 0.002),
           ("elementwise_kernel", 0.002, 0.0021),
           ("sm90_xmma_gemm_f32f32", 0.0021, 0.003),
           ("sm90_xmma_gemm_f32f32", 0.003, 0.004)]
    tr = devtrace.Trace(dev, [], (0.0, 0.01), [(0.0, 0.01)])
    run = _run([{"shape": (64, 39), "molecules": 64, "atoms": [27] * 64}],
               window=(0.0, 0.01), trace=tr, cfg=cfg)
    share = spec.reader("edge_bwd_roofline.train").read(run)
    bound = flops.edge_pass_bound(64, 39, 420, 2, "float32", "gcl",
                                  backward=True)[0]
    assert share == pytest.approx(100 * bound / (0.002 + 0.0009))
    assert spec.reader("edge_fwd_roofline.train").read(run) is None
    assert spec.reader("train_mol_per_s").read(run) == pytest.approx(6400.0)
