"""The attention kernels' tile classification
(``kernels/local_attention.py::tile_schedule``, which mirrors the CUDA
source) against a brute-force count over the causal sliding-window mask.

bfloat16: per 128-row block the kernel visits the key tiles from
``(q_lo - window + 1) // 64`` to ``q_hi // 64``; per warpgroup (64 rows,
those past S left out) and visited tile it runs Q K^T unless no 16-key
chunk holds an unmasked pair, P V on the chunks that hold one, and the
mask only where some pair of the 64 rows (past S included) x 64 keys is
masked.  float32 (``F32_TILES``): 64-row blocks and 64-key tiles, each
warp of 8 rows classifying on its own and running P V on the groups of 4
keys that hold an unmasked pair.  Every count must equal the brute-force
one, exactly.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.kernels.local_attention import (  # noqa: E402
    F32_TILES,
    TC_BLOCK_K,
    TC_BLOCK_Q,
    TC_CHUNK,
    TC_ROWS,
    tile_schedule,
)

BF16_TILES = dict(block_q=TC_BLOCK_Q, block_k=TC_BLOCK_K, rows=TC_ROWS,
                  chunk=TC_CHUNK)


def _keep(rows, keys, window):
    """Unmasked (row, key) pairs: key <= row and key > row - window."""
    r, k = np.meshgrid(rows, keys, indexing="ij")
    return (k <= r) & (k > r - window)


def _brute_force(s, window, block_q, block_k, rows, chunk):
    window = min(window, s)
    visited = full = partial = skipped = s_pairs = pv_pairs = 0
    for q_lo in range(0, s, block_q):
        block = np.arange(q_lo, min(q_lo + block_q, s))
        for k_lo in range(0, s, block_k):
            keys = np.arange(k_lo, min(k_lo + block_k, s))
            if not _keep(block, keys, window).any():
                continue
            visited += 1
            for r_lo in range(q_lo, block[-1] + 1, rows):
                group = np.arange(r_lo, min(r_lo + rows, s))
                live = sum(
                    _keep(group, np.arange(c, min(c + chunk, s)),
                          window).any()
                    for c in range(k_lo, k_lo + block_k, chunk) if c < s)
                if not live:
                    skipped += 1
                    continue
                # all the group's rows, those past S too, against all keys
                if _keep(np.arange(r_lo, r_lo + rows),
                         np.arange(k_lo, k_lo + block_k), window).all():
                    full += 1
                else:
                    partial += 1
                s_pairs += rows * block_k
                pv_pairs += rows * chunk * live
    unmasked = int(_keep(np.arange(s), np.arange(s), window).sum())
    return (visited, full, partial, skipped, s_pairs, pv_pairs, unmasked)


@pytest.mark.parametrize("s,window", [
    (37, 1), (37, 37), (64, 64), (130, 7), (300, 1000), (777, 63),
    (777, 65), (777, 100), (1000, 513), (2049, 2049), (2048, 512)])
def test_tile_schedule_matches_brute_force(s, window):
    got = tile_schedule(s, window)
    assert tuple(got) == _brute_force(s, window, **BF16_TILES)
    # the products cover every unmasked pair, and at most 4 D per pair
    # computed is what operations() counts
    assert got.pv_pairs >= got.unmasked_pairs
    assert got.operations(256) == 2 * 256 * (got.s_pairs + got.pv_pairs)


def test_gemma3_prefill_schedule():
    """gemma3-1b's prefill (S = 2048): a local layer (window 512) runs its
    products on 12.5% more pairs than it needs, a global one on 3.1%."""
    local, glob = tile_schedule(2048, 512), tile_schedule(2048, 2048)
    assert local.unmasked_pairs == 512 * 513 // 2 + 1536 * 512
    assert glob.unmasked_pairs == 2048 * 2049 // 2
    assert local.operations(256) / (4 * 256 * local.unmasked_pairs) \
        == pytest.approx(1.125, abs=1e-3)
    assert glob.operations(256) / (4 * 256 * glob.unmasked_pairs) \
        == pytest.approx(1.031, abs=1e-3)


@pytest.mark.parametrize("s,window", [
    (37, 1), (37, 37), (63, 4), (64, 8), (65, 9), (64, 64), (65, 63),
    (129, 3), (129, 65), (130, 7), (300, 1000), (777, 63), (777, 100),
    (777, 777), (1000, 513), (2048, 512)])
def test_f32_tile_schedule_matches_brute_force(s, window):
    """The float32 kernel's tiles: every count, and nothing but whole
    visited tiles is left out of the range (the 64-row block's range has
    no tile without an unmasked pair)."""
    got = tile_schedule(s, window, **F32_TILES)
    assert tuple(got) == _brute_force(s, window, **F32_TILES)
    assert got.pv_pairs >= got.unmasked_pairs
    assert got.s_pairs >= got.unmasked_pairs


def test_gemma3_f32_prefill_schedule():
    """gemma3-1b's prefill in float32: the kernel's products run on 7.0%
    more pairs than a local layer needs (12.5% for whole tiles), 1.7%
    more than a global one."""
    local = tile_schedule(2048, 512, **F32_TILES)
    glob = tile_schedule(2048, 2048, **F32_TILES)
    assert local.operations(256) / (4 * 256 * local.unmasked_pairs) \
        == pytest.approx(1.0700, abs=1e-3)
    assert glob.operations(256) / (4 * 256 * glob.unmasked_pairs) \
        == pytest.approx(1.0171, abs=1e-3)
