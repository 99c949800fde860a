"""The decode wrapper's chunk plan (pure Python, no card): how many
chunks of whole 128-position tiles the split kernel cuts the cache into,
and how many tiles each chunk holds."""

import numpy as np
import pytest

from repro_torch.kernels.decode_attention.kernel import (MAX_SPLITS, TILE,
                                                         split_plan)


@pytest.mark.parametrize("kv", [4, 8])
def test_split_plan(kv):
    # the served shape on an H100 (132 SMs): B=8, kv_len 1881
    splits, per = split_plan(8, kv, 1881, 132)
    assert 8 * kv * splits >= 2 * 132
    assert (splits - 1) * per * TILE < 1881 <= splits * per * TILE
    rng = np.random.default_rng(kv)
    for b, kv_len, n_sm in zip(rng.integers(1, 65, 200),
                               rng.integers(1, 8193, 200),
                               rng.choice([16, 108, 132], 200)):
        b, kv_len, n_sm = int(b), int(kv_len), int(n_sm)
        splits, per = split_plan(b, kv, kv_len, n_sm)
        n_tiles = -(-kv_len // TILE)
        # every chunk holds at least one tile, and together they cover
        # the cache exactly up to its last tile
        assert splits >= 1 and per >= 1
        assert (splits - 1) * per < n_tiles <= splits * per
        # enough blocks where the cache has enough tiles for them
        assert b * kv * splits >= min(2 * n_sm, b * kv * n_tiles)
    for kv_len in (1, 17, TILE):
        assert split_plan(8, kv, kv_len, 132) == (1, 1)
    # a cache far longer than the served one: the combine's chunk cap
    splits, per = split_plan(1, 1, 2 ** 20 + 1, 1000)
    assert splits <= MAX_SPLITS
    assert (splits - 1) * per < -(-(2 ** 20 + 1) // TILE) <= splits * per
    assert split_plan(264 // kv, kv, 1881, 132)[0] == 1   # B * KV fills it
