"""PLY reading (copy of point_cloud_viewer_tpu/io/ply.py:31-194, the reader
only; the JAX package's writers stay there).

The reader parses the header on the host and then consumes the body with one
`np.frombuffer` per batch over a structured dtype (reference:
src/read_write/ply.rs:232-315).  Mapping rules preserved from the reference
(src/read_write/ply.rs:352-455):

* properties x/y/z (any float width) become the f64 `position`,
* r/red, g/green, b/blue (u8) become the `color` U8Vec3,
* a/alpha is skipped,
* other scalar properties keep their dtype when it is one of
  {u8, u64, i64, f32, f64}; i8/u16/i16/u32/i32 properties are skipped,
* a header line `comment offset: X Y Z` translates all positions.

Binary little-endian is the primary format; ASCII is also accepted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.constants import NUM_POINTS_PER_BATCH
from ..core.points_batch import PointsBatch

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "longlong": "i8", "int64": "i8",
    "ulonglong": "u8", "uint64": "u8",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_COLOR_CHANNELS = {"r": 0, "red": 0, "g": 1, "green": 1, "b": 2, "blue": 2}
# Scalar attribute dtypes kept when reading (others are skipped).
_KEPT_ATTR_DTYPES = {"u1", "u8", "i8", "f4", "f8"}


@dataclass
class PlyHeader:
    fmt: str  # 'binary_little_endian' | 'binary_big_endian' | 'ascii'
    num_vertices: int
    properties: List[Tuple[str, str]]  # (name, numpy dtype str) in file order
    offset: np.ndarray  # (3,) translation from 'comment offset:' lines
    header_len: int  # bytes


def parse_header(f) -> PlyHeader:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    num_vertices = None
    properties: List[Tuple[str, str]] = []
    offset = np.zeros(3)
    current_element = None
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        entries = line.decode("ascii", "replace").split()
        if not entries:
            continue
        if entries[0] == "format":
            fmt = entries[1]
        elif entries[0] == "element":
            current_element = entries[1]
            if current_element == "vertex":
                num_vertices = int(entries[2])
        elif entries[0] == "property" and current_element == "vertex":
            if entries[1] == "list":
                raise ValueError("list properties on vertex are unsupported")
            dtype = _PLY_DTYPES.get(entries[1])
            if dtype is None:
                raise ValueError(f"unknown PLY data type {entries[1]}")
            properties.append((entries[2], dtype))
        elif entries[0] == "comment" and len(entries) == 5 and entries[1] == "offset:":
            offset = np.array([float(v) for v in entries[2:5]])
        elif entries[0] == "end_header":
            break
    if fmt is None or num_vertices is None:
        raise ValueError("PLY header missing format or vertex element")
    return PlyHeader(
        fmt=fmt,
        num_vertices=num_vertices,
        properties=properties,
        offset=offset,
        header_len=f.tell(),
    )


class PlyReader:
    """Batched PLY reader producing PointsBatch objects."""

    def __init__(self, path: str, batch_size: int = NUM_POINTS_PER_BATCH) -> None:
        self.path = path
        self.batch_size = batch_size
        with open(path, "rb") as f:
            self.header = parse_header(f)
        names = [p[0] for p in self.header.properties]
        for axis in "xyz":
            if axis not in names:
                raise ValueError("PLY must contain properties 'x', 'y', 'z' for 'vertex'.")
        endian = ">" if self.header.fmt == "binary_big_endian" else "<"
        self._dtype = np.dtype(
            [(f"f{i}", endian + d) for i, (_, d) in enumerate(self.header.properties)]
        )

    @property
    def num_points(self) -> int:
        return self.header.num_vertices

    def _to_batch(self, rows: np.ndarray) -> PointsBatch:
        names = [p[0] for p in self.header.properties]
        cols = {name: rows[f"f{i}"] for i, name in enumerate(names)}
        position = np.stack(
            [cols["x"].astype(np.float64), cols["y"].astype(np.float64),
             cols["z"].astype(np.float64)],
            axis=1,
        )
        position += self.header.offset
        attributes: Dict[str, np.ndarray] = {}
        color: Optional[np.ndarray] = None
        for name, dtype in self.header.properties:
            if name in ("x", "y", "z", "a", "alpha"):
                continue
            if name in _COLOR_CHANNELS:
                if dtype != "u1":
                    # The reference accepts only u8 color channels and
                    # fails loudly otherwise (read_write/ply.rs:467-469);
                    # casting a float/wide-int channel into u8 would
                    # silently corrupt colors.
                    raise ValueError(
                        f"PLY color property {name!r} must be uchar, "
                        f"got {dtype!r}"
                    )
                if color is None:
                    color = np.zeros((len(rows), 3), dtype=np.uint8)
                color[:, _COLOR_CHANNELS[name]] = cols[name]
                continue
            if dtype not in _KEPT_ATTR_DTYPES:
                continue  # reference skips narrow int attribute dtypes
            attributes[name] = cols[name]
        if color is not None:
            attributes["color"] = color
        return PointsBatch(position=position, attributes=attributes)

    def __iter__(self) -> Iterator[PointsBatch]:
        if self.header.fmt == "ascii":
            yield from self._iter_ascii()
            return
        point_size = self._dtype.itemsize
        with open(self.path, "rb") as f:
            f.seek(self.header.header_len)
            remaining = self.header.num_vertices
            while remaining > 0:
                n = min(remaining, self.batch_size)
                buf = f.read(n * point_size)
                if len(buf) < n * point_size:
                    raise ValueError("PLY body truncated")
                yield self._to_batch(np.frombuffer(buf, dtype=self._dtype))
                remaining -= n

    def _iter_ascii(self) -> Iterator[PointsBatch]:
        with open(self.path, "rb") as f:
            f.seek(self.header.header_len)
            data = np.loadtxt(f, ndmin=2, max_rows=self.header.num_vertices)
        rows = np.rec.fromarrays(
            [data[:, i].astype(self._dtype[i]) for i in range(len(self.header.properties))],
            dtype=np.dtype([(f"f{i}", self._dtype[i].str.lstrip("<>"))
                            for i in range(len(self.header.properties))]),
        )
        for start in range(0, len(rows), self.batch_size):
            yield self._to_batch(rows[start : start + self.batch_size])

    def read_all(self) -> PointsBatch:
        return PointsBatch.concatenate(list(self))
