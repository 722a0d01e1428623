"""A node table's NodeIds made in one pass over its id columns
(`node_id.ids_at`, `Octree.node_ids_at`) and the viewer's id list that uses
them (`render_loop.node_id_list`): each equal, id for id, to the list built
by indexing the table's `node_ids` one row at a time, over the format's
full level range, on tables opened through either meta decoder."""

import numpy as np
import pytest

from point_cloud_viewer_tpu_torch.io.node_io import DataProvider
from point_cloud_viewer_tpu_torch.octree.node_id import (
    MAX_FORMAT_LEVEL, NodeId, ids_at, split_upper_words, unpack_ids)
from point_cloud_viewer_tpu_torch.octree.octree import Octree, _LazyNodeIds
from point_cloud_viewer_tpu_torch.protos.meta import (
    BoundingBoxProto, MetaProto, OctreeMetaProto, OctreeNodeProto,
    PositionEncodingProto)
from point_cloud_viewer_tpu_torch.viewer.render_loop import node_id_list

MASK64 = (1 << 64) - 1
DECODERS = ["native", "python"]
KINDS = ["all", "reversed", "repeated", "ends", "empty"]


class _Meta(DataProvider):
    """A meta.pb in memory: as bytes for the native parser, or only as a
    decoded message, which sends the octree to the Python decoder."""

    def __init__(self, meta: MetaProto, native: bool) -> None:
        self.meta, self.native = meta, native

    def meta_proto(self) -> MetaProto:
        return self.meta

    def meta_bytes(self):
        return self.meta.encode() if self.native else None


@pytest.fixture(scope="module")
def meta():
    """The root, then 300 distinct nodes of levels 1-21 (one-word paths)
    and 300 of levels 22-40 (two-word paths), shuffled."""
    rng = np.random.default_rng(2**31 + 17)
    levels = np.concatenate([rng.integers(1, 22, 300),
                             rng.integers(22, MAX_FORMAT_LEVEL + 1, 300)])
    values = {0}
    for lv in levels.tolist():
        path = int.from_bytes(rng.bytes(16), "little") % (8 ** lv)
        values.add(lv << 120 | path)
    values = sorted(values)
    rng.shuffle(values)
    nodes = [OctreeNodeProto(v, 1 + i, PositionEncodingProto.UINT16)
             for i, v in enumerate(values)]
    return MetaProto(bounding_box=BoundingBoxProto((-5.0, -3.0, 1.0),
                                                   (7.0, 2.0, 4.0)),
                     octree=OctreeMetaProto(resolution=0.001, nodes=nodes))


@pytest.fixture(scope="module")
def octrees(meta):
    trees = {d: Octree(_Meta(meta, d == "native")) for d in DECODERS}
    assert isinstance(trees["native"].node_ids, _LazyNodeIds)
    assert isinstance(trees["python"].node_ids, list)
    levels = trees["native"].levels
    assert levels.min() == 0 and levels.max() == MAX_FORMAT_LEVEL
    assert (trees["native"].path_hi != 0).any()
    return trees


def _rows(kind: str, n: int, dtype) -> np.ndarray:
    rng = np.random.default_rng(7)
    rows = {"all": np.arange(n),
            "reversed": np.arange(n)[::-1],
            "repeated": rng.integers(0, n, 3 * n),
            "ends": np.array([0, n - 1, 0, n - 1]),
            "empty": np.arange(0)}[kind]
    return rows.astype(dtype)


def _same_ids(got, want):
    """The same NodeIds in the same order, by every face a NodeId shows."""
    assert len(got) == len(want)
    assert all(type(g) is NodeId for g in got)
    assert [g.value for g in got] == [w.value for w in want]
    assert [hash(g) for g in got] == [hash(w) for w in want]
    assert [str(g) for g in got] == [str(w) for w in want]
    assert got == want
    assert [a < b for a, b in zip(got, got[1:])] == [
        a < b for a, b in zip(want, want[1:])]
    assert [g.level for g in got] == [w.level for w in want]


def test_both_decoders_fill_the_same_id_columns(octrees):
    native, python = octrees["native"], octrees["python"]
    for column in ("levels", "path_hi", "path_lo"):
        a, b = getattr(native, column), getattr(python, column)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(native.node_ids) == python.node_ids


def test_split_upper_words_undoes_the_parsers_upper_word(octrees):
    python = octrees["python"]
    ids = python.node_ids
    upper = np.array([n.value >> 64 for n in ids], dtype=np.uint64)
    levels, path_hi = split_upper_words(upper)
    want_levels, want_hi, _ = unpack_ids(ids)
    assert levels.dtype == np.uint8 and np.array_equal(levels, want_levels)
    assert path_hi.dtype == np.uint64 and np.array_equal(path_hi, want_hi)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("decoder", DECODERS)
def test_node_ids_at_equals_the_rows_ids_one_by_one(octrees, decoder, kind,
                                                    dtype):
    octree = octrees[decoder]
    rows = _rows(kind, len(octree), dtype)
    _same_ids(octree.node_ids_at(rows), [octree.node_ids[i] for i in rows])


@pytest.mark.parametrize("decoder", DECODERS)
def test_node_ids_at_gives_the_ids_the_columns_pack(octrees, decoder):
    octree = octrees[decoder]
    ids = octree.node_ids_at(np.arange(len(octree)))
    for node, lv, hi, lo in zip(ids, octree.levels.tolist(),
                                octree.path_hi.tolist(),
                                octree.path_lo.tolist()):
        assert node == NodeId.from_level_index(lv, hi << 64 | lo)
        assert str(node) == "r" + (format(hi << 64 | lo, "o").zfill(lv)
                                   if lv else "")


@pytest.mark.parametrize("rows", [[3, 1, 3], (0,), []])
@pytest.mark.parametrize("decoder", DECODERS)
def test_node_ids_at_accepts_python_sequences(octrees, decoder, rows):
    octree = octrees[decoder]
    _same_ids(octree.node_ids_at(rows), [octree.node_ids[i] for i in rows])


def test_ids_at_reads_only_the_columns_it_is_given():
    """Columns of two-word paths that no octree holds: the root and the
    deepest level, with every path bit set."""
    levels = np.array([0, MAX_FORMAT_LEVEL, 1, MAX_FORMAT_LEVEL],
                      dtype=np.uint8)
    paths = [0, (1 << 120) - 1, 7, 1 << 119]
    path_hi = np.array([p >> 64 for p in paths], dtype=np.uint64)
    path_lo = np.array([p & MASK64 for p in paths], dtype=np.uint64)
    rows = np.array([3, 0, 1, 2, 1], dtype=np.int32)
    _same_ids(ids_at(levels, path_hi, path_lo, rows),
              [_LazyNodeIds(levels, path_hi, path_lo)[i] for i in rows])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("decoder", DECODERS)
def test_node_id_list_equals_the_rows_ids_one_by_one(octrees, decoder, kind,
                                                     dtype):
    octree = octrees[decoder]
    rows = _rows(kind, len(octree), dtype)
    _same_ids(node_id_list(octree, rows), [octree.node_ids[i] for i in rows])
