"""K4's promotion stage in the PyTorch port (point_cloud_viewer_tpu_torch/
ops/level_cuda.py `promote_stage`) on the CPU, tolerance 0 (integer state):

* its plain version against the JAX package: the looped formulation
  (`_assign_and_promote_looped`, leaf and final levels) and the Pallas K4
  (`level_pallas.promote_pass`, interpret mode) once a level, with
  stop_level 0 and > 0 and with pad rows;
* a numpy model of the CUDA kernel's algorithm (csrc/promote.cu): the
  (segment started, count mod 8) carry combined across arbitrary lane, warp
  and tile cuts, the look-back over the tiles' published states (each seen
  as it was first published or as it ended), and the shortcut that skips
  the look-back where no active row precedes a tile's first start; it must
  equal the plain loop on any input (hypothesis).

The kernel itself is held to the plain version on a card in
tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from point_cloud_viewer_tpu.ops import level_pallas as LP
from point_cloud_viewer_tpu.ops import morton as jax_morton
from point_cloud_viewer_tpu.ops import tree_build as jax_tb
from point_cloud_viewer_tpu_torch.ops import level_cuda as LC
from point_cloud_viewer_tpu_torch.ops import morton
from point_cloud_viewer_tpu_torch.ops import tree_build as tb

_BLOCK = 8 * LP.LANES  # the JAX kernels' block at ROWS = 8
_TILE = 8192
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


def _jax_looped(codes, n_real, root, stop, depth=_DEPTH):
    """JAX leaf and final levels, pad rows as 0xFFFFFFFF sentinels."""
    codes = codes.copy()
    codes[n_real:] = np.uint64(2**64 - 1)
    hi, lo = (jnp.asarray(h) for h in jax_morton.split_u64(codes))
    leaf, cur = jax_tb._assign_and_promote_looped(hi, lo, depth, depth,
                                                  _THRESHOLD, root, stop)
    return np.asarray(leaf), np.asarray(cur)


def _port_stage(codes, n_real, root, stop, depth=_DEPTH):
    b, leaf = tb.leaf_stage(morton.codes_to_tensor(codes, "cpu"), depth,
                            depth, _THRESHOLD, root, n_real)
    return b, leaf, LC.promote_stage(b, leaf, depth, stop)


_CASES = [  # (n, one_cell), as tests/test_torch_level.py
    (_BLOCK - 1, False), (_BLOCK, False), (_BLOCK + 1, False),
    (3 * _BLOCK + 17, False), (2 * _BLOCK + 5, True),
    (_TILE - 1, False), (_TILE, False), (_TILE + 1, False),
    (2 * _TILE + 5, False),
]


@pytest.mark.parametrize("root,stop", [(0, 0), (0, 3), (2, 2)])
@pytest.mark.parametrize("n,one_cell", _CASES)
def test_stage_plain_matches_jax_looped(n, one_cell, root, stop):
    codes = _sorted_codes(n, seed=n + root, one_cell=one_cell)
    _, leaf, cur = _port_stage(codes, n, root, stop)
    want_leaf, want_cur = _jax_looped(codes, n, root, stop)
    np.testing.assert_array_equal(leaf.numpy(), want_leaf)
    np.testing.assert_array_equal(cur.numpy(), want_cur)
    assert cur.dtype == torch.uint8 and not torch.equal(cur, leaf)


@pytest.mark.parametrize("root,stop,pad", [(0, 0, 37), (1, 1, 5),
                                           (0, 3, 1001), (2, 4, 1)])
def test_stage_plain_pad_rows_match_jax_looped(root, stop, pad):
    """Pad rows (n_real < n) are promoted as the JAX sentinel rows are."""
    n = 6000 + pad
    rng = np.random.default_rng(pad)
    codes = np.sort(_sorted_codes(n, seed=pad + root))
    n_real = n - pad
    codes[n_real:] = rng.permutation(codes[n_real:])
    _, leaf, cur = _port_stage(codes, n_real, root, stop)
    want_leaf, want_cur = _jax_looped(codes, n_real, root, stop)
    np.testing.assert_array_equal(leaf.numpy(), want_leaf)
    np.testing.assert_array_equal(cur.numpy(), want_cur)


def _pad(x, value):
    return jnp.pad(jnp.asarray(x), (0, (-len(x)) % _BLOCK),
                   constant_values=value)


@pytest.mark.parametrize("stop", [0, 2])
@pytest.mark.parametrize("n,one_cell", [_CASES[0], _CASES[3], _CASES[4],
                                        _CASES[8]])
def test_stage_plain_matches_pallas_per_level(n, one_cell, stop):
    """The stage against the Pallas K4 in interpret mode, once a level from
    max_split_level down to stop_level + 1, from the same leaf levels."""
    codes = _sorted_codes(n, seed=n + 7, one_cell=one_cell)
    b, leaf, cur = _port_stage(codes, n, 0, stop)
    b_pad = _pad(b.numpy(), 255)
    want = leaf.numpy()
    for level in range(_DEPTH, stop, -1):
        want = np.asarray(LP.promote_pass(b_pad, _pad(want, 0), level,
                                          interpret=True))[:n]
    np.testing.assert_array_equal(cur.numpy(), want)


def test_stage_loop_and_plain_agree_and_launch_nothing_on_cpu():
    codes = _sorted_codes(3000, seed=4)
    b, leaf, cur = _port_stage(codes, 3000, 0, 1)
    counts = (LC.promote_pass.launches, LC.promote_stage.launches)
    assert torch.equal(LC.promote_stage_loop(b, leaf, _DEPTH, 1), cur)
    assert torch.equal(LC.promote_stage_plain(b, leaf, _DEPTH, 1), cur)
    assert (LC.promote_pass.launches, LC.promote_stage.launches) == counts
    # No level to promote: a copy of the leaf, never the leaf itself.
    same = LC.promote_stage(b, leaf, 3, 3)
    assert torch.equal(same, leaf) and same.data_ptr() != leaf.data_ptr()


def test_stage_rejects_bad_input():
    b = torch.zeros(10, dtype=torch.uint8)
    for args in ((b, b[:9], 3, 0), (b, b.to(torch.int32), 3, 0),
                 (b, b, 3, 4), (b, b, 64, 0), (b, b, 3, -1)):
        with pytest.raises(ValueError):
            LC.promote_stage(*args)
    for level in (0, 64):
        with pytest.raises(ValueError):
            LC.promote_pass(b, b.clone(), level)


# --- a numpy model of csrc/promote.cu ------------------------------------


def _combine(a, c):
    """(f1, r1) . (f2, r2), packed f << 3 | r; `a` is the earlier range."""
    return c if c & 8 else (a & 8) | ((a + c) & 7)


def _scan(values):
    """Exclusive prefixes and the total of `values` under _combine."""
    run, excl = 0, []
    for v in values:
        excl.append(run)
        run = _combine(run, v)
    return excl, run


def _lane(m, a):
    """A lane's (f, r) and whether an active row precedes its first
    start; m, a: bool arrays of its starts and active rows."""
    if not a.any():
        return (8 if m.any() else 0), False
    if m.any():
        first, last = np.flatnonzero(m)[[0, -1]]
        return 8 | int(a[last:].sum()) & 7, bool(a[:first].any())
    return int(a.sum()) & 7, True


def _promoted(m, a, r):
    """The lane's event walk: active rows of rank 0 mod 8, the count r
    carried in and reset at each start."""
    out = np.zeros(len(a), dtype=bool)
    for i in range(len(a)):
        if m[i]:
            r = 0
        if a[i]:
            out[i] = r % 8 == 0
            r += 1
    return out


def _kernel_model(b, cur, hi, levels, tiles, rng):
    """csrc/promote.cu's algorithm on numpy rows.  `tiles`: a list of tiles,
    each a list of warps, each a list of (start, end) lane row ranges,
    covering the rows in order.  Tiles run in order, but a look-back sees
    each predecessor's state either as it was first published or as it
    ended (rng).  Returns (cur, look-backs made, look-backs skipped where
    the tile held an active row)."""
    cur = cur.copy()
    waits = skips = 0
    for k in range(levels):
        level = hi - k
        first_state, final_state = [], []
        for t, warps in enumerate(tiles):
            lanes = []  # (start, end, m, a, agg, pre)
            for warp in warps:
                for s, e in warp:
                    m, a = b[s:e] <= level, cur[s:e] == level
                    lanes.append((s, e, m, a, *_lane(m, a)))
            # Warps: each lane's prefix within its warp, the warp's total,
            # and whether an active row of it precedes every start of it.
            lane_excl, warp_totals, warp_pre, i = [], [], [], 0
            for warp in warps:
                part = lanes[i:i + len(warp)]
                i += len(warp)
                excl, total = _scan([x[4] for x in part])
                lane_excl.append(excl)
                warp_totals.append(total)
                warp_pre.append(any(x[5] and not ex & 8
                                    for x, ex in zip(part, excl)))
            wex, tile_agg = _scan(warp_totals)
            need = any(pre and not any(w & 8 for w in warp_totals[:j])
                       for j, pre in enumerate(warp_pre))
            closed = t == 0 or bool(tile_agg & 8)
            first_state.append((closed, tile_agg))
            final_state.append((closed, tile_agg))
            carry = 0
            if need and t > 0:
                waits += 1
                j = t - 1
                while True:  # the look-back, nearest predecessor first
                    done, v = (first_state[j] if rng.random() < 0.5
                               else final_state[j])
                    carry = _combine(v, carry)
                    if done:
                        break
                    j -= 1
                if not closed:
                    final_state[t] = (True, _combine(carry, tile_agg))
            elif t > 0 and any(x[3].any() for x in lanes):
                skips += 1
            i = 0
            for w, warp in enumerate(warps):
                for li in range(len(warp)):
                    s, e, m, a, _, _ = lanes[i]
                    i += 1
                    r = _combine(_combine(carry, wex[w]), lane_excl[w][li])
                    cur[s:e][_promoted(m, a, r & 7)] = level - 1
    return cur, waits, skips


def _cut(n, cuts):
    """Row ranges of [0, n) split at the sorted distinct `cuts`."""
    edges = [0, *sorted({c for c in cuts if 0 < c < n}), n]
    return list(zip(edges, edges[1:]))


def _tiles(n, lane_cuts, warp_every, tile_every):
    lanes = _cut(n, lane_cuts)
    warps = [lanes[i:i + warp_every] for i in range(0, len(lanes), warp_every)]
    return [warps[i:i + tile_every] for i in range(0, len(warps), tile_every)]


def _inputs(kind, n, hi, seed):
    rng = np.random.default_rng(seed)
    if kind == "start only, all active":
        b = np.full(n, hi + 1, dtype=np.uint8)
        b[0] = 0
        return b, np.full(n, hi, dtype=np.uint8)
    if kind == "codes":
        b, leaf, _ = _port_stage(_sorted_codes(n, seed), n, 0, 0)
        return b.numpy(), leaf.numpy()
    # Arbitrary bytes: rows before the first start, b past every level.
    b = rng.choice(np.array([0, 1, 2, 3, 5, 7, 200], dtype=np.uint8), n,
                   p=[0.02, 0.03, 0.05, 0.1, 0.2, 0.3, 0.3])
    return b, rng.integers(0, hi + 2, n).astype(np.uint8)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(data=st.data(),
       kind=st.sampled_from(["arbitrary", "start only, all active", "codes"]),
       n=st.integers(1, 700))
def test_kernel_model_matches_plain_loop(data, kind, n):
    hi = _DEPTH if kind == "codes" else data.draw(st.integers(1, 6))
    stop = data.draw(st.integers(0, hi))
    b, cur = _inputs(kind, n, hi, seed=n)
    lane_cuts = data.draw(st.lists(st.integers(1, max(n - 1, 1)),
                                   max_size=40))
    tiles = _tiles(n, lane_cuts, data.draw(st.integers(1, 4)),
                   data.draw(st.integers(1, 4)))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1)))
    got, _, _ = _kernel_model(b, cur, hi, hi - stop, tiles, rng)
    want = LC.promote_stage_plain(torch.from_numpy(b), torch.from_numpy(cur),
                                  hi, stop)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("kind", ["codes", "start only, all active"])
def test_kernel_model_waits_and_skips_at_32_row_lanes(kind):
    """The model at the kernel's own shape (32-row lanes, 4 warps a tile)
    equals the plain loop; on the code input some tiles that hold active
    rows skip the look-back and some wait, and on the start-only input,
    where every tile holds active rows before its first start at the
    deepest level, none skips there."""
    n = 5000
    b, cur = _inputs(kind, n, _DEPTH, seed=3)
    tiles = _tiles(n, range(32, n, 32), 4, 4)
    got, waits, skips = _kernel_model(b, cur, _DEPTH, _DEPTH, tiles,
                                      np.random.default_rng(0))
    want = LC.promote_stage_plain(torch.from_numpy(b), torch.from_numpy(cur),
                                  _DEPTH, 0)
    np.testing.assert_array_equal(got, want.numpy())
    assert waits > 0
    if kind == "codes":
        assert skips > 0
    else:
        _, first_waits, first_skips = _kernel_model(
            b, cur, _DEPTH, 1, tiles, np.random.default_rng(0))
        assert (first_waits, first_skips) == (len(tiles) - 1, 0)


def test_carry_monoid_is_associative_with_identity():
    values = range(16)
    for a in values:
        assert _combine(0, a) == _combine(a, 0) == a
        for c in values:
            for d in values:
                assert _combine(_combine(a, c), d) == _combine(a, _combine(c, d))
