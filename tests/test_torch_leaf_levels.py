"""K6 of the PyTorch port (point_cloud_viewer_tpu_torch/ops/leaf_levels_cuda.py)
on the CPU: its plain version against the JAX package's
`leaf_levels_pallas` in interpret mode and against the leaf output of the
port's device core, on the same numpy-seeded sorted codes.  Integer
outputs: tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_viewer_tpu.ops import morton as jax_morton
from point_cloud_viewer_tpu.ops.tree_build_pallas import leaf_levels_pallas
from point_cloud_viewer_tpu_torch.ops import leaf_levels_cuda as K6
from point_cloud_viewer_tpu_torch.ops import tree_build as tb


def _sorted_codes(n, depth, kind, seed=0):
    """The inputs of tests/test_tree_build_pallas.py:32-59."""
    rng = np.random.default_rng(seed)
    if kind == "dups":
        cells = rng.integers(0, 4, (n, 3)).astype(np.uint32)
    else:
        cells = rng.integers(0, 2 ** depth, (n, 3)).astype(np.uint32)
    return np.sort(jax_morton.morton_encode(cells))


def _jax_leaf(codes, depth, max_split, t):
    hi, lo = jax_morton.split_u64(codes)
    return np.asarray(leaf_levels_pallas(
        jnp.asarray(hi), jnp.asarray(lo), depth, max_split, t,
        interpret=True))


def _port(codes):
    return torch.from_numpy(np.ascontiguousarray(codes).view(np.int64))


def _core_leaf(codes, depth, max_split, t):
    out = tb.build_tree_device_codes_grouped(
        _port(codes), len(codes), depth, max_split, t)
    return out.leaf.to(torch.int32).numpy()


@pytest.mark.parametrize("n,depth,t,kind", [
    (5000, 9, 100, "random"),
    (3000, 9, 10, "dups"),
    (2048, 5, 7, "exact-tile"),
    (100, 3, 2, "tiny"),
    (20_000, 12, 50, "multi-chunk"),
])
def test_plain_matches_jax_pallas_and_core(n, depth, t, kind, monkeypatch):
    if kind == "multi-chunk":
        from point_cloud_viewer_tpu.ops import tree_build_pallas as tbp

        monkeypatch.setattr(tbp, "_CHUNK", 8192)
    codes = _sorted_codes(n, depth, kind)
    got = K6.leaf_levels(_port(codes), depth, depth, t)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), _jax_leaf(codes, depth, depth, t))
    np.testing.assert_array_equal(got.numpy(), _core_leaf(codes, depth, depth, t))


@pytest.mark.parametrize("depth,max_split", [(4, 7), (6, 9)])
def test_depth_below_max_split_matches_jax(depth, max_split):
    """Levels past `depth` hold one segment (row 0 starts it), as the
    Pallas kernel's invalid lanes; duplicate runs above the threshold then
    fall through to max_split_level."""
    codes = _sorted_codes(3000, depth, "dups", seed=4)
    got = K6.leaf_levels(_port(codes), depth, max_split, 20)
    want = _jax_leaf(codes, depth, max_split, 20)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == max_split).any()


def test_max_split_below_depth_matches_jax():
    codes = _sorted_codes(4000, 9, "random", seed=5)
    got = K6.leaf_levels(_port(codes), 9, 3, 30)
    np.testing.assert_array_equal(got.numpy(), _jax_leaf(codes, 9, 3, 30))


@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_single(n):
    codes = _sorted_codes(n, 6, "random", seed=6)
    got = K6.leaf_levels(_port(codes), 6, 6, 3)
    assert got.dtype == torch.int32 and got.shape == (n,)
    if n:
        np.testing.assert_array_equal(got.numpy(), _jax_leaf(codes, 6, 6, 3))
        assert got.tolist() == [1]


def test_maximal_codes_match_jax_and_core():
    """Runs of 2^63 - 1, the largest code the port's int64 keys hold."""
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 2**63, 6000, dtype=np.uint64)
    codes[:2500] = np.uint64(2**63 - 1)
    codes[2500:2600] = codes[2600] & ~np.uint64(2**20 - 1)
    codes = np.sort(codes)
    for t in (50, 3000):
        got = K6.leaf_levels(_port(codes), 21, 21, t)
        np.testing.assert_array_equal(got.numpy(), _jax_leaf(codes, 21, 21, t))
        np.testing.assert_array_equal(got.numpy(), _core_leaf(codes, 21, 21, t))


@pytest.mark.parametrize("t,expect", [(0, "max"), (10_000, "one")])
def test_threshold_extremes(t, expect):
    codes = _sorted_codes(2000, 7, "random", seed=9)
    got = K6.leaf_levels(_port(codes), 7, 7, t).numpy()
    np.testing.assert_array_equal(got, _jax_leaf(codes, 7, 7, t))
    assert (got == (7 if expect == "max" else 1)).all()


def test_cpu_call_counts_no_launch_and_rejects_bad_input():
    codes = _port(_sorted_codes(500, 5, "random"))
    before = K6.leaf_levels.launches, K6.leaf_stage.launches
    K6.leaf_levels(codes, 5, 5, 10)
    K6.leaf_stage(codes, 5, 5, 10)
    assert (K6.leaf_levels.launches, K6.leaf_stage.launches) == before
    with pytest.raises(ValueError):
        K6.leaf_levels(codes.to(torch.int32), 5, 5, 10)
    with pytest.raises(ValueError):
        K6.leaf_levels(codes, 5, 22, 10)
