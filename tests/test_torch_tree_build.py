"""The device core of the PyTorch port (point_cloud_viewer_tpu_torch/ops/
tree_build.py) against the JAX package's (ops/tree_build.py) on the CPU:
the same numpy-seeded codes through both, every output compared with
tolerance 0 (integer state).  On the CPU the port runs its kernels' plain
versions; the JAX side runs its own CPU formulation."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from point_cloud_viewer_tpu.ops import morton as jax_morton
from point_cloud_viewer_tpu.ops import tree_build as jax_tb
from point_cloud_viewer_tpu_torch.ops import morton
from point_cloud_viewer_tpu_torch.ops import tree_build as tb

_DEPTH = 8


def _hot_codes(n, seed, root_level=0, depth=_DEPTH):
    """u64 codes with heavy duplicates (as test_device_ops.py:175-203);
    with root_level > 0, all inside one level-root_level cell."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 1 << (depth - root_level), (n, 3)).astype(np.uint32)
    cells[::5] = cells[0]
    return jax_morton.morton_encode(cells)


def _jax_grouped(codes, n_real, max_points, root, stop, cap, depth=_DEPTH):
    hi, lo = jax_morton.split_u64(codes)
    return jax_tb.build_tree_device_codes_grouped(
        jnp.asarray(hi), jnp.asarray(lo), jnp.int32(n_real), depth, depth,
        max_points, root, stop, cap,
    )


def _assert_grouped_equal(got, want):
    assert len(got) == len(want) == 8
    for name, g, w in zip(tb.GroupedExchange._fields, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("root,stop", [(0, 0), (2, 2), (0, 3)])
def test_grouped_matches_jax(root, stop):
    codes = _hot_codes(20_000, seed=17, root_level=root)
    want = _jax_grouped(codes, len(codes), 100, root, stop, 512)
    got = tb.build_tree_device_codes_grouped(
        morton.codes_to_tensor(codes, "cpu"), len(codes), _DEPTH, _DEPTH,
        100, root, stop, 512)
    _assert_grouped_equal(got, want)


@pytest.mark.parametrize("root,stop", [(0, 0), (2, 2), (0, 3)])
def test_codes_core_matches_jax(root, stop):
    codes = _hot_codes(20_000, seed=18, root_level=root)
    hi, lo = jax_morton.split_u64(codes)
    want = jax_tb.build_tree_device_codes(
        jnp.asarray(hi), jnp.asarray(lo), _DEPTH, _DEPTH, 100, root, stop)
    got = tb.build_tree_device_codes(
        morton.codes_to_tensor(codes, "cpu"), _DEPTH, _DEPTH, 100, root, stop)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_grouped_hot_cells_deep_splits():
    """A dense hot cell and a second dense run split to the depth cap."""
    rng = np.random.default_rng(3)
    cells = rng.integers(0, 1 << _DEPTH, (9_000, 3)).astype(np.uint32)
    top = np.full((700, 3), 2**_DEPTH - 1, dtype=np.uint32)  # maximal cell
    mid = np.full((650, 3), 17, dtype=np.uint32)
    codes = jax_morton.morton_encode(np.concatenate([cells, top, mid]))
    want = _jax_grouped(codes, len(codes), 512, 0, 0, 512)
    got = tb.build_tree_device_codes_grouped(
        morton.codes_to_tensor(codes, "cpu"), len(codes), _DEPTH, _DEPTH, 512)
    _assert_grouped_equal(got, want)
    assert int(got.leaf[-1]) == _DEPTH


@pytest.mark.parametrize("n", [0, 1])
def test_grouped_empty_and_one_point(n):
    codes = _hot_codes(n, seed=5) if n else np.zeros(0, dtype=np.uint64)
    want = _jax_grouped(codes, n, 100, 0, 0, 512)
    got = tb.build_tree_device_codes_grouped(
        morton.codes_to_tensor(codes, "cpu"), n, _DEPTH, _DEPTH, 100)
    _assert_grouped_equal(got, want)


def test_grouped_extras_overflow():
    """More 1-point leaves than extras_cap: the spill slot absorbs the
    rest and extras_total reports the true count."""
    rng = np.random.default_rng(11)
    cells = rng.integers(0, 1 << _DEPTH, (3_000, 3)).astype(np.uint32)
    codes = jax_morton.morton_encode(cells)
    want = _jax_grouped(codes, len(codes), 4, 0, 0, 3)
    got = tb.build_tree_device_codes_grouped(
        morton.codes_to_tensor(codes, "cpu"), len(codes), _DEPTH, _DEPTH, 4,
        extras_cap=3)
    _assert_grouped_equal(got, want)
    assert int(got.extras_total) > 3


@pytest.mark.parametrize("root,stop", [(0, 0), (2, 2), (0, 3)])
def test_grouped_matches_native_tree_levels(root, stop):
    """The host-native kernel (the JAX package's n >= 100k route,
    builder.py:706-712) at the full 21-level code budget: leaf and final
    levels bit for bit on the sorted order, level_counts its bincount."""
    from point_cloud_viewer_tpu import native

    assert native.available()
    depth = 21
    codes = _hot_codes(30_000, seed=23, root_level=root, depth=depth)
    got = tb.build_tree_device_codes_grouped(
        morton.codes_to_tensor(codes, "cpu"), len(codes), depth, depth, 100,
        root, stop, extras_cap=4096)
    sorted_codes, order = morton.argsort_codes(codes)
    leaf, final = native.tree_levels(sorted_codes, depth, depth, 100, root,
                                     stop)
    np.testing.assert_array_equal(got.idx.numpy(), order)
    np.testing.assert_array_equal(got.leaf.numpy(), leaf)
    np.testing.assert_array_equal(got.final.numpy(), final)
    np.testing.assert_array_equal(got.level_counts.numpy(),
                                  np.bincount(final, minlength=depth + 2))
    np.testing.assert_array_equal(got.order2.numpy(),
                                  order[np.argsort(final, kind="stable")])


@pytest.mark.parametrize("root,stop", [(0, 0), (2, 2)])
def test_grouped_padded_matches_jax_sentinels(root, stop):
    """n_real < n: the JAX side gets pad_codes_pow2's 0xFFFFFFFF sentinel
    rows, the port the same rows joined to int64 (-1), left unsorted."""
    codes = _hot_codes(9_000, seed=42, root_level=root)
    codes = np.concatenate([codes, np.full(40, (1 << 63) - 1, np.uint64)])
    hi, lo = jax_morton.split_u64(codes)
    ph, pl, n = jax_tb.pad_codes_pow2(hi, lo)
    assert len(ph) > n
    want = jax_tb.build_tree_device_codes_grouped(
        jnp.asarray(ph), jnp.asarray(pl), jnp.int32(n), _DEPTH, _DEPTH,
        100, root, stop, 512)
    got = tb.build_tree_device_codes_grouped(
        morton.from_jax_halves(ph, pl), n, _DEPTH, _DEPTH, 100, root, stop,
        512)
    _assert_grouped_equal(got, want)


def test_bound_levels_matches_jax_above_2_53():
    """The high-bit search must be exact where a float log2 rounds: codes
    near 2^63, including the maximal code, on a depth-21 grid."""
    rng = np.random.default_rng(2)
    codes = np.sort(np.concatenate([
        rng.integers(0, 2**63, 5_000, dtype=np.uint64),
        np.uint64(2**63) - rng.integers(1, 2**12, 500, dtype=np.uint64),
        np.full(30, 2**63 - 1, dtype=np.uint64),
        np.uint64(2**53) + rng.integers(0, 2**4, 100, dtype=np.uint64),
    ]))
    hi, lo = jax_morton.split_u64(codes)
    want = jax_tb._bound_levels(jnp.asarray(hi), jnp.asarray(lo), 21)
    got = tb._bound_levels(morton.codes_to_tensor(codes, "cpu"), 21)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_morton_host_half_matches_jax():
    rng = np.random.default_rng(4)
    cells = rng.integers(0, 2**21, (1_000, 3)).astype(np.uint32)
    np.testing.assert_array_equal(
        morton.morton_encode(cells), jax_morton.morton_encode(cells))
    pos = rng.random((1_000, 3)) * 50.0
    got, _ = morton.quantize_and_encode(pos, np.zeros(3), 64.0, 18)
    want, _ = jax_morton.quantize_and_encode(pos, np.zeros(3), 64.0, 18)
    np.testing.assert_array_equal(got, want)
    hi, lo = morton.split_u64(got)
    np.testing.assert_array_equal(morton.join_u64(hi, lo), got)
    np.testing.assert_array_equal(
        morton.from_jax_halves(hi, lo).numpy(), got.view(np.int64))


def test_core_rejects_bad_arguments():
    codes = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tb.build_tree_device_codes(codes.to(torch.int32), 4, 4)
    with pytest.raises(ValueError):
        tb.build_tree_device_codes_grouped(codes, 5, 4, 4)
    with pytest.raises(ValueError):
        tb.build_tree_device_codes(codes, 4, 4, root_level=3, stop_level=2)
    with pytest.raises(ValueError):
        morton.codes_to_tensor(np.array([2**63], dtype=np.uint64), "cpu")



def _skip_empty_assign_and_promote(sorted_codes, depth, max_points, root,
                                   stop, n_real):
    """The formulation the sync-free derivation replaced: promotion skips
    the levels where no point rests (a host read per level)."""
    from point_cloud_viewer_tpu_torch.ops import level_cuda as LC

    b = tb._bound_levels(sorted_codes, depth, n_real)
    n = b.shape[0]
    leaf = torch.full((n,), depth, dtype=torch.uint8)
    found = torch.zeros(n, dtype=torch.uint8)
    for level in range(root + 1, depth + 1):
        LC.leaf_update_pass(b, LC.seg_start_pass(b, level), leaf, found,
                            level, max_points)
    cur = leaf.clone()
    for level in range(depth, stop, -1):
        if bool((cur == level).any()):
            LC.promote_pass(b, cur, level)
    return leaf, cur


@pytest.mark.parametrize("root,stop,pad", [(0, 0, 0), (2, 2, 0), (0, 3, 37),
                                           (1, 1, 5)])
def test_sync_free_derivation_matches_skip_empty_formulation_and_jax(
        root, stop, pad):
    """Every level promoted (empty ones are no-ops) and the level counts
    taken from the sorted key: bit-equal to the per-level-skip loop with
    torch.bincount, and to the JAX package."""
    codes = _hot_codes(12_000, seed=31 + root + pad, root_level=root)
    n_real = len(codes)
    codes = np.concatenate([codes, np.full(pad, 2**63 - 1, np.uint64)])
    got = tb.build_tree_device_codes_grouped(
        morton.codes_to_tensor(codes, "cpu"), n_real, _DEPTH, _DEPTH, 60,
        root, stop, 512)
    sorted_codes = torch.cat([
        torch.sort(morton.codes_to_tensor(codes[:n_real], "cpu")).values,
        morton.codes_to_tensor(codes[n_real:], "cpu")])
    leaf, cur = _skip_empty_assign_and_promote(sorted_codes, _DEPTH, 60,
                                               root, stop, n_real)
    assert torch.equal(got.leaf, leaf) and torch.equal(got.final, cur)
    key = cur.clone()
    key[n_real:] = _DEPTH + 1
    assert torch.equal(got.level_counts,
                       torch.bincount(key, minlength=_DEPTH + 2).int())
    if pad == 0:
        _assert_grouped_equal(got, _jax_grouped(codes, n_real, 60, root,
                                                stop, 512))


def test_async_dispatch_and_fetch_match_jax(monkeypatch):
    """tree_codes_grouped_on_device + fetch_grouped (the streaming
    bucket's round trip) against the JAX padded call, both exchanges."""
    codes = _hot_codes(15_000, seed=44, root_level=1)
    for cap in (None, 2):
        out = tb.tree_codes_grouped_on_device(
            codes, _DEPTH, _DEPTH, root_level=1, stop_level=1, device="cpu",
            extras_cap=cap, max_points_per_node=80)
        hi, lo = jax_morton.split_u64(codes)
        want, n = jax_tb.tree_codes_grouped_on_device_padded(
            hi, lo, _DEPTH, _DEPTH, 80, 1, 1,
            extras_cap=max(512, len(codes) >> 6) if cap is None else cap)
        got = tb.fetch_grouped(out)
        want = [np.asarray(w) for w in want]
        total = int(want[4])
        assert got.overflow == (total > len(want[2])) == (cap == 2)
        if got.overflow:
            np.testing.assert_array_equal(got.idx, want[5][:n])
            np.testing.assert_array_equal(got.final, want[6][:n])
            np.testing.assert_array_equal(got.leaf, want[7][:n])
            assert got.nbytes == 4 + 6 * n
        else:
            np.testing.assert_array_equal(got.order2, want[0][:n])
            np.testing.assert_array_equal(got.level_counts[:-1],
                                          want[1][:-1])
            np.testing.assert_array_equal(got.extras_idx, want[2][:total])
            np.testing.assert_array_equal(got.extras_level, want[3][:total])


def _jax_leaf_stage(codes, n_real, depth, max_split, t, root):
    """The JAX package's leaf levels on the same rows, with its pad rows
    as 0xFFFFFFFF sentinels: the looped formulation and the fused one
    (level_pallas K2 + K3 in interpret mode)."""
    codes = codes.copy()
    codes[n_real:] = np.uint64(2**64 - 1)
    hi, lo = (jnp.asarray(h) for h in jax_morton.split_u64(codes))
    looped = jax_tb._assign_and_promote_looped(hi, lo, depth, max_split, t,
                                               root, root)[0]
    fused = jax_tb._assign_and_promote_fused(hi, lo, depth, max_split, t,
                                             root, root, interpret=True)[0]
    return np.asarray(looped), np.asarray(fused)


def _above_2_53(n, seed):
    rng = np.random.default_rng(seed)
    codes = np.concatenate([
        rng.integers(0, 2**63, n - 600, dtype=np.uint64),
        np.uint64(2**63) - rng.integers(1, 2**12, 500, dtype=np.uint64),
        np.full(100, 2**63 - 1, dtype=np.uint64)])
    return codes


@pytest.mark.parametrize("case,n,depth,max_split,t,root,pad", [
    ("root 0", 6000, _DEPTH, _DEPTH, 100, 0, 0),
    ("root 2", 6000, _DEPTH, _DEPTH, 100, 2, 0),
    ("pad rows", 6000, _DEPTH, _DEPTH, 60, 0, 37),
    ("pad rows, root 1", 5000, _DEPTH, _DEPTH, 60, 1, 5),
    ("max_split > depth", 4000, 5, 9, 20, 0, 0),
    ("max_split > depth, root 3, pad", 4000, 5, 9, 20, 3, 11),
    ("max_split < depth", 4000, 9, 4, 30, 0, 0),
    ("codes above 2^53", 6000, 21, 21, 40, 0, 3),
    ("one point", 1, _DEPTH, _DEPTH, 100, 0, 0),
    ("one pad row", 1, _DEPTH, _DEPTH, 100, 0, 1),
])
def test_leaf_stage_plain_matches_jax(case, n, depth, max_split, t, root,
                                      pad):
    """The core's leaf stage on the CPU (its plain version: `_bound_levels`
    + the K2 + K3 loop) against the JAX package's two formulations, leaf
    for leaf; b against JAX `_bound_levels` on the real rows."""
    if depth == 21:
        codes = np.sort(_above_2_53(n, seed=n))
    else:
        codes = np.sort(_hot_codes(n, seed=n + pad, root_level=root,
                                   depth=depth))
    n_real = n - pad
    codes[n_real:] = np.random.default_rng(1).permutation(codes[n_real:])
    b, leaf = tb.leaf_stage(morton.codes_to_tensor(codes, "cpu"), depth,
                            max_split, t, root, n_real)
    assert b.dtype == leaf.dtype == torch.uint8 and leaf.shape == (n,)
    looped, fused = _jax_leaf_stage(codes, n_real, depth, max_split, t, root)
    np.testing.assert_array_equal(leaf.numpy(), looped, err_msg=case)
    np.testing.assert_array_equal(leaf.numpy(), fused, err_msg=case)
    hi, lo = jax_morton.split_u64(codes[:n_real])
    if n_real:
        np.testing.assert_array_equal(
            b[:n_real].numpy(),
            np.asarray(jax_tb._bound_levels(jnp.asarray(hi), jnp.asarray(lo),
                                            depth)), err_msg=case)


def test_leaf_stage_empty_and_bad_arguments():
    empty = torch.zeros(0, dtype=torch.int64)
    b, leaf = tb.leaf_stage(empty, _DEPTH, _DEPTH, 100)
    assert b.shape == leaf.shape == (0,)
    assert b.dtype == leaf.dtype == torch.uint8
    codes = torch.arange(10, dtype=torch.int64)
    for args in ((_DEPTH, _DEPTH, 100, _DEPTH), (_DEPTH, 22, 100),
                 (22, 21, 100), (_DEPTH, _DEPTH, 100, 0, 11)):
        with pytest.raises(ValueError):
            tb.leaf_stage(codes, *args)
    with pytest.raises(ValueError):
        tb.leaf_stage(codes.to(torch.int32), _DEPTH, _DEPTH, 100)


def test_leaf_stage_threshold_past_int32():
    """A threshold past 2^31 keeps every segment small (an unclamped one
    would wrap when compared with the int32 counts)."""
    codes = torch.sort(morton.codes_to_tensor(_hot_codes(3000, seed=9),
                                              "cpu")).values
    _, leaf = tb.leaf_stage(codes, _DEPTH, _DEPTH, 2**40)
    assert (leaf == 1).all()
    _, leaf = tb.leaf_stage(codes, _DEPTH, _DEPTH, 2**31 - 1)
    assert (leaf == 1).all()
