"""The packed form of W1 that the bf16 edge-pass kernel reads, and its cache.

``pack_w1`` is plain torch on any device, so the layout is held here on the
CPU: the kernel's view of it (tile, row, swizzled 16-byte chunk) is spelled
out below independently of the function.
"""

import gc

import numpy as np
import pytest
import torch

from ml_conformer_generator_tpu_torch.ops import gcl_kernel as gk

NP, NH, KT = 448, 224, 64   # padded rows, rows per tile, columns per tile


def _rows1(H):
    """Rows of a half-1 tile: the kernel runs half 1 32 columns wide where
    224 < H <= 256 (GEOM-Drugs' 256), else 224 (MLCG's 420 as 200)."""
    return 32 if NH < H <= NH + 32 else NH


def _unpack(packed, H):
    """The padded (NH + rows1, HP) matrix that ``pack_w1`` laid out: tiles
    by (half, K-tile), a half-0 tile NH rows and a half-1 tile rows1, rows
    of 8 chunks of 8 values, chunk d of row r at d ^ (r % 8)."""
    nkt, rows1 = -(-H // KT), _rows1(H)
    halves = []
    for rows, flat in zip((NH, rows1), packed.split(
            [nkt * NH * KT, nkt * rows1 * KT])):
        tiles = flat.view(nkt, rows, 8, 8)
        idx = (torch.arange(8)[None, :] ^ (torch.arange(rows)[:, None] % 8))
        idx = idx[None, :, :, None].expand_as(tiles)
        halves.append(torch.gather(tiles, 2, idx).permute(1, 0, 2, 3)
                      .reshape(rows, nkt * KT))
    return torch.cat(halves)


def _w1(H, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((H, H)).astype(np.float32)
                        ).to(torch.bfloat16)


@pytest.mark.parametrize("H", [64, 420, 256])
def test_unpack_gives_zero_padded_w1(H):
    w1 = _w1(H)
    HP = KT * -(-H // KT)
    packed = gk.pack_w1(w1)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.numel() == (NH + _rows1(H)) * HP
    want = torch.zeros(NH + _rows1(H), HP, dtype=torch.bfloat16)
    want[:H, :H] = w1
    assert torch.equal(_unpack(packed, H), want)


@pytest.mark.parametrize("H", [64, 420, 256])
def test_packed_layout_is_the_kernels(H):
    """Element (n, k) sits in K-tile k // 64 of half n // 224: tile k // 64
    of half 0 (224 rows of 128 bytes each), or after half 0's nkt tiles,
    tile k // 64 of half 1 (rows1 rows each); row n % 224, 16-byte chunk
    ((k % 64) // 8) ^ (row % 8), place k % 8."""
    w1 = _w1(H, seed=1)
    nkt, rows1 = -(-H // KT), _rows1(H)
    packed = gk.pack_w1(w1)
    rng = np.random.default_rng(2)
    for n, k in zip(rng.integers(0, H, 300), rng.integers(0, H, 300)):
        half, row = divmod(int(n), NH)
        kt, kk = divmod(int(k), KT)
        chunk, place = divmod(kk, 8)
        tile = kt * NH if half == 0 else nkt * NH + kt * rows1
        at = ((tile + row) * 8 + (chunk ^ (row % 8))) * 8
        assert packed[at + place] == w1[n, k]


def test_pack_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        gk.pack_w1(torch.zeros(64, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        gk.pack_w1(torch.zeros(452, 452, dtype=torch.bfloat16))


def test_cache_returns_the_same_pack_for_the_same_weight():
    lin = torch.nn.Linear(64, 64).to(torch.bfloat16)
    gk.reset_pack_count()
    first = gk.packed_w1(lin.weight)
    assert gk.packed_w1(lin.weight) is first
    assert gk.PACKS == 1


def test_cache_repacks_after_an_inplace_update():
    lin = torch.nn.Linear(64, 64).to(torch.bfloat16)
    gk.reset_pack_count()
    first = gk.packed_w1(lin.weight)
    with torch.no_grad():
        lin.weight.mul_(2.0)
    second = gk.packed_w1(lin.weight)
    assert second is not first and gk.PACKS == 2
    assert torch.equal(_unpack(second, 64)[:64], lin.weight.detach())


def test_cache_repacks_after_load_state_dict_and_after_to():
    lin = torch.nn.Linear(64, 64).to(torch.bfloat16)
    gk.reset_pack_count()
    first = gk.packed_w1(lin.weight)
    lin.load_state_dict({k: torch.ones_like(v)
                         for k, v in lin.state_dict().items()})
    second = gk.packed_w1(lin.weight)
    assert second is not first and gk.PACKS == 2
    assert torch.equal(_unpack(second, 64)[:64],
                       torch.ones(64, 64, dtype=torch.bfloat16))
    lin = lin.to(torch.float32).to(torch.bfloat16)   # new storage
    assert gk.packed_w1(lin.weight) is not second and gk.PACKS == 3


def test_cache_keeps_no_entry_of_a_dead_weight():
    gc.collect()
    before = len(gk._PACK_CACHE)
    for _ in range(5):
        gk.packed_w1(_w1(64))
    gc.collect()
    assert len(gk._PACK_CACHE) == before
