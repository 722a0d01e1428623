"""K2-K4 of the PyTorch port (point_cloud_viewer_tpu_torch/ops/level_cuda.py)
against the JAX Pallas kernels (ops/level_pallas) in interpret mode with
small blocks, as tests/test_level_pallas.py runs them.  Integer state:
tolerance 0.  The CUDA kernels themselves are checked against their plain
versions on a card, in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_viewer_tpu.ops import level_pallas as LP
from point_cloud_viewer_tpu.ops import morton as jax_morton
from point_cloud_viewer_tpu.ops import tree_build as jax_tb
from point_cloud_viewer_tpu_torch.ops import _ext
from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
from point_cloud_viewer_tpu_torch.ops.tree_build import _bound_levels

_BLOCK = 8 * LP.LANES  # the JAX kernels' block at ROWS = 8
_THRESHOLD = 50
_DEPTH = 6


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setattr(LP, "ROWS", 8)
    monkeypatch.setattr(LP, "_BLOCK", _BLOCK)


def _sorted_codes(n, seed, one_cell=False):
    """Sorted u64 codes on the 2^6 grid with a hot cell (or all in one)."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 2**_DEPTH, (n, 3), dtype=np.uint32)
    cells[: n // 10] = cells[0]
    if one_cell:
        cells[:] = 0
    return np.sort(jax_morton.morton_encode(cells))


def _states(n, seed, one_cell=False):
    """(b as JAX block-padded u8, b as torch u8) for sorted codes."""
    codes = _sorted_codes(n, seed, one_cell)
    hi, lo = jax_morton.split_u64(codes)
    b_jax = jax_tb._bound_levels(jnp.asarray(hi), jnp.asarray(lo), _DEPTH)
    b_pad = jnp.pad(b_jax, (0, (-n) % _BLOCK), constant_values=255)
    b_t = _bound_levels(torch.from_numpy(codes.view(np.int64)), _DEPTH)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_jax))
    return b_pad, b_t


def _pad(x, value):
    return jnp.pad(jnp.asarray(x), (0, (-len(x)) % _BLOCK),
                   constant_values=value)


_TILE = _ext.LOOKBACK_TILE  # K2's CUDA tile (lookback_scan.cuh)
_CASES = [
    (_BLOCK - 1, False), (_BLOCK, False), (_BLOCK + 1, False),
    (3 * _BLOCK + 17, False), (2 * _BLOCK + 5, True),
    (_TILE - 1, False), (_TILE, False), (_TILE + 1, False),
    (2 * _TILE + 5, False),
]


@pytest.mark.parametrize("n,one_cell", _CASES)
def test_leaf_sweeps_match_jax_pallas(n, one_cell):
    """K2 + K3 over every level, from the same state on both sides."""
    b_pad, b_t = _states(n, seed=n, one_cell=one_cell)
    leaf = np.full(n, _DEPTH, dtype=np.uint8)
    found = np.zeros(n, dtype=np.uint8)
    leaf_t, found_t = torch.from_numpy(leaf.copy()), torch.from_numpy(found)
    for level in range(1, _DEPTH + 1):
        ss_jax = LP.seg_start_pass(b_pad, level, interpret=True)
        ss_t = LC.seg_start_pass(b_t, level)
        np.testing.assert_array_equal(ss_t.numpy(), np.asarray(ss_jax)[:n])
        leaf_j, found_j = LP.leaf_update_pass(
            b_pad, ss_jax, _pad(leaf, _DEPTH), _pad(found, 0), level,
            jnp.int32(_THRESHOLD), jnp.int32(n), interpret=True,
        )
        LC.leaf_update_pass(b_t, ss_t, leaf_t, found_t, level, _THRESHOLD)
        leaf = np.asarray(leaf_j)[:n]
        found = np.asarray(found_j)[:n]
        np.testing.assert_array_equal(leaf_t.numpy(), leaf)
        np.testing.assert_array_equal(found_t.numpy(), found)


@pytest.mark.parametrize("n,one_cell", _CASES)
def test_promote_matches_jax_pallas(n, one_cell):
    """K4 over every promotion level, from leaf levels of the real rules."""
    b_pad, b_t = _states(n, seed=n + 1, one_cell=one_cell)
    codes = _sorted_codes(n, seed=n + 1, one_cell=one_cell)
    hi, lo = jax_morton.split_u64(codes)
    leaf, _ = jax_tb._assign_and_promote_looped(
        jnp.asarray(hi), jnp.asarray(lo), _DEPTH, _DEPTH, _THRESHOLD, 0, 0)
    cur = np.asarray(leaf).astype(np.uint8)
    cur_t = torch.from_numpy(cur.copy())
    for level in range(_DEPTH, 0, -1):
        cur = np.asarray(
            LP.promote_pass(b_pad, _pad(cur, 0), level, interpret=True))[:n]
        LC.promote_pass(b_t, cur_t, level)
        np.testing.assert_array_equal(cur_t.numpy(), cur)


@pytest.mark.parametrize("n", [_TILE - 1, _TILE + 1, 2 * _TILE + 5])
def test_seg_start_single_start_matches_jax_pallas(n):
    """K2 where element 0 is the only start: the shallow levels' case, in
    which the carry crosses every block (and, on the card, every tile's
    look-back runs back to the first tile)."""
    b = np.full(n, _DEPTH + 1, dtype=np.uint8)
    b[0] = 0
    b_pad = _pad(b, 255)
    for level in range(1, _DEPTH + 1):
        want = np.asarray(LP.seg_start_pass(b_pad, level, interpret=True))[:n]
        got = LC.seg_start_pass(torch.from_numpy(b), level)
        np.testing.assert_array_equal(got.numpy(), want)
        assert not want.any()


def test_plain_versions_leave_counters_at_zero():
    b = torch.zeros(10, dtype=torch.uint8)
    counts = (LC.seg_start_pass.launches, LC.leaf_update_pass.launches,
              LC.promote_pass.launches)
    ss = LC.seg_start_pass(b, 1)
    LC.leaf_update_pass(b, ss, torch.zeros_like(b), torch.zeros_like(b), 1, 5)
    LC.promote_pass(b, torch.ones_like(b), 1)
    assert (LC.seg_start_pass.launches, LC.leaf_update_pass.launches,
            LC.promote_pass.launches) == counts


def test_level_wrappers_reject_bad_input():
    b = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError):
        LC.seg_start_pass(b.to(torch.int32), 1)
    with pytest.raises(ValueError):
        LC.leaf_update_pass(b, torch.zeros(9, dtype=torch.int32),
                            torch.zeros_like(b), torch.zeros_like(b), 1, 5)
    with pytest.raises(ValueError):
        LC.promote_pass(b, torch.zeros(10, dtype=torch.int32), 1)

