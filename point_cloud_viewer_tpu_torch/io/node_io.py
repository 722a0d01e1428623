"""Per-node attribute file I/O and the DataProvider abstraction (copy of
point_cloud_viewer_tpu/io/node_io.py:27-174, trimmed to what the builders,
the octree, the S2 cells and the providers of io/factory.py call).

On-disk layout (the reference's contract, src/read_write/raw.rs:361-450 and
src/data_provider/on_disk.rs:11-69): a point-cloud directory contains
`meta.pb` plus, per node, one little-endian flat binary file per attribute —
`<stem>.xyz` for positions (interleaved x,y,z in the node's position
encoding), `<stem>.rgb` for color (u8 triplets), `<stem>.<attr>` otherwise.
The stem is the octree node name (`r053`) or an S2 cell token.  Empty files are never left
behind (the reference deletes zero-byte files on writer drop,
src/read_write/node_writer.rs:78-89).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable

import numpy as np

from ..core.attributes import AttributeDataType, attribute_extension
from ..core.constants import META_FILENAME
from ..core.points_batch import PointsBatch
from ..ops.codec import PositionEncoding, decode_positions
from ..protos.meta import MetaProto


def attempt_increasing_rlimit_to_max() -> None:
    """Raise this process's open-file soft limit to its hard limit, failing
    silently — builds open one file per (node, attribute) and users hit
    'cannot open more files' otherwise (reference:
    src/read_write/mod.rs:43-56, called at the top of build_octree,
    src/octree/generation.rs:296)."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft != hard:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    except Exception:  # noqa: BLE001 - best-effort, like the reference
        pass


class DataProvider:
    """Storage abstraction: metadata bytes + per-node attribute blobs
    (reference trait: src/data_provider/common.rs:6-13)."""

    def meta_proto(self) -> MetaProto:
        raise NotImplementedError

    def meta_bytes(self):
        """Raw meta.pb bytes, or None — enables the native fast parser."""
        return None

    def data(self, node_name: str, attributes: Iterable[str]) -> Dict[str, bytes]:
        raise NotImplementedError


class NodeNotFound(KeyError):
    pass


class OnDiskDataProvider(DataProvider):
    def __init__(self, directory: str) -> None:
        self.directory = directory
        self._prefix = (
            directory if directory.endswith(os.sep) else directory + os.sep
        )

    def stem(self, node_name: str) -> str:
        return self._prefix + node_name

    def meta_proto(self) -> MetaProto:
        return MetaProto.decode(self.meta_bytes())

    def meta_bytes(self) -> bytes:
        with open(os.path.join(self.directory, META_FILENAME), "rb") as f:
            return f.read()

    def data(self, node_name: str, attributes: Iterable[str]) -> Dict[str, bytes]:
        out = {}
        for attribute in attributes:
            path = self.stem(node_name) + "." + attribute_extension(attribute)
            try:
                with open(path, "rb") as f:
                    out[attribute] = f.read()
            except FileNotFoundError:
                raise NodeNotFound(path)
        return out


# ---------------------------------------------------------------------------
# Writing


def write_node_files(
    stem: str,
    encoded_positions: np.ndarray,
    attributes: Dict[str, np.ndarray],
) -> int:
    """Write one node: `<stem>.xyz` + one file per attribute.  Returns the
    number of points written.  Zero-length nodes write nothing and existing
    files for the stem are removed (truncate semantics)."""
    paths = [stem + ".xyz"] + [
        stem + "." + attribute_extension(name) for name in attributes
    ]
    n = len(encoded_positions)
    if n == 0:
        for p in paths:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
        return 0
    with open(stem + ".xyz", "wb") as f:
        np.ascontiguousarray(encoded_positions).tofile(f)
    for name, arr in attributes.items():
        if len(arr) != n:
            raise ValueError(f"attribute {name} length {len(arr)} != {n}")
        with open(stem + "." + attribute_extension(name), "wb") as f:
            np.ascontiguousarray(_little_endian(arr)).tofile(f)
    return n


def _little_endian(arr: np.ndarray) -> np.ndarray:
    dt = np.dtype(arr.dtype)
    if dt.byteorder == ">":
        return arr.astype(dt.newbyteorder("<"))
    return arr


# ---------------------------------------------------------------------------
# Reading


def parse_attribute_bytes(buf: bytes, data_type: AttributeDataType) -> np.ndarray:
    arr = np.frombuffer(buf, dtype=data_type.numpy_dtype.newbyteorder("<"))
    if data_type.dim == 3:
        arr = arr.reshape(-1, 3)
    return arr


def read_node_batch(
    provider: DataProvider,
    node_name: str,
    attribute_data_types: Dict[str, AttributeDataType],
    encoding: PositionEncoding,
    cube_min: np.ndarray,
    edge_length: float,
) -> PointsBatch:
    """Read a full node into a PointsBatch with world-space f64 positions."""
    blobs = provider.data(node_name, ["position", *attribute_data_types])
    pos_raw = np.frombuffer(blobs["position"], dtype=encoding.numpy_dtype).reshape(-1, 3)
    position = decode_positions(pos_raw, cube_min, edge_length, encoding)
    attributes = {
        name: parse_attribute_bytes(blobs[name], dt)
        for name, dt in attribute_data_types.items()
    }
    return PointsBatch(position=position, attributes=attributes)
