"""Faults planted in the float32 kernels' wide paths (128 < N <= 192), each
under a whole run of the EDM GEOM-Drugs training cell on the card, at its
own sizes and limits: a fault is a mutated copy of one kernel source,
built beside the sound libraries (a library is named by its source's hash)
and loaded in their place for the run. On the CPU only the mutations'
anchors in the sources are checked; the runs skip without a card.

    python3 -m pytest benchmark/tests/test_benchmark_f32_wide_faults.py -s

prints each fault's checks beside their limits."""

import json
import os

import pytest

from conftest import ROOT

CELL = "train-drugs-f32-b64"
CSRC = os.path.join(ROOT, "ml_conformer_generator_tpu_torch", "csrc")
#: The forward's wide j-sum over a tile's source nodes (jsum_half_wide).
_JSUM = ("for (int j = 0; j < nsrc; ++j) {\n"
         "      const int r = ti * nsrc + j;\n"
         "      const float4 m = *reinterpret_cast<const float4*>"
         "(stash + r * kLdS + c);\n"
         "      const float w = gw[r];")
#: name: (source, text, its replacement, whether the cell's checks see it).
FAULTS = {
    # the tail tile's messages (source nodes 128..N-1) left out of the
    # forward's gated j-sum
    "fwd_tail_dropped": (
        "edge_mlp_f32", _JSUM,
        _JSUM.replace("j < nsrc;", "j < (tail ? 0 : nsrc);"), True),
    # the backward's dv partial of the tail tile's source nodes written as
    # zeros
    "bwd_tail_dv_dropped": (
        "edge_mlp_bwd_f32", "      __stcg(at, s);",
        "      __stcg(at, tail ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : s);",
        True),
    # one source node, the tail's first (128), left out of the forward's
    # j-sum
    "one_source_node_dropped": (
        "edge_mlp_f32", _JSUM, _JSUM.replace("int j = 0;",
                                             "int j = tail ? 1 : 0;"), True),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_mutation_anchors_are_in_the_sources(name):
    source, old, new, _ = FAULTS[name]
    with open(os.path.join(CSRC, f"{source}.cu")) as f:
        assert f.read().count(old) == 1
    assert new != old


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_wide_fault_reads_not_correct(name, tmp_path, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    from benchmark import harness
    from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk

    source, old, new, seen = FAULTS[name]
    with open(os.path.join(CSRC, f"{source}.cu")) as f:
        text = f.read()
    mutated = tmp_path / f"{source}.cu"
    mutated.write_text(text.replace(old, new))
    monkeypatch.setitem(gk._SOURCES, source, str(mutated))
    monkeypatch.setattr(gk, "_libs", None)
    harness.set_cache_dirs()
    out, _ = harness.execute(harness.Spec(CELL), 2300000011, 1.0, False,
                             "cuda")
    print(f"FAULT {name} {json.dumps(out['checks'])}", flush=True)
    assert out["correct"] is (not seen), out["checks"]
