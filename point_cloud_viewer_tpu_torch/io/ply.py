"""PLY reading and writing (copy of point_cloud_viewer_tpu/io/ply.py:31-349:
the reader, the type names and the writers, PlyStreamWriter and write_ply
at :197-349, unchanged).

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

import os
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

# Inverse of _PLY_DTYPES for writing (canonical PLY names).
_PLY_TYPE_NAMES = {
    "u1": "uchar", "u2": "ushort", "u4": "uint", "u8": "ulonglong",
    "i1": "char", "i2": "short", "i4": "int", "i8": "longlong",
    "f4": "float", "f8": "double",
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


class PlyStreamWriter:
    """Incremental PLY writer: batches are appended as they stream and the
    vertex count (a fixed-width placeholder) is patched on close — the
    reference's PlyNodeWriter pattern (src/read_write/ply.rs:559-732).

    The attribute schema is fixed by the first batch.  Supports appending
    to an existing PLY written by this class (vertex counts add up).
    """

    _COUNT_WIDTH = 20

    def __init__(self, path: str, append: bool = False) -> None:
        self.path = path
        self.count = 0
        self._schema = None  # [(prop name, dtype code)] incl. x/y/z
        self._count_pos = None
        if append and os.path.exists(path) and os.path.getsize(path) > 0:
            self._open_existing()
        else:
            self._file = open(path, "wb")

    def _open_existing(self) -> None:
        with open(self.path, "rb") as f:
            header = parse_header(f)
        if header.fmt != "binary_little_endian":
            raise ValueError(
                f"can only append to binary_little_endian PLYs, "
                f"file is {header.fmt}"
            )
        self._file = open(self.path, "r+b")
        self._file.seek(0, 2)  # append at end
        self.count = header.num_vertices
        # Locate the fixed-width count in the header for patching.
        head = open(self.path, "rb").read(header.header_len).decode("ascii")
        marker = "element vertex "
        i = head.index(marker) + len(marker)
        self._count_pos = i
        # Batches must match the existing header's property layout exactly,
        # else the body desynchronizes from the declared record format.
        self._schema = list(header.properties)

    @staticmethod
    def _batch_props(batch: PointsBatch):
        """Property list (name, dtype code) a batch's records produce —
        the layout _write_header declares and write() emits."""
        props = [("x", "f8"), ("y", "f8"), ("z", "f8")]
        for name, arr in batch.attributes.items():
            code = np.dtype(arr.dtype).str.lstrip("<>=|")
            if arr.ndim == 2:
                channels = (
                    ["red", "green", "blue", "alpha"][: arr.shape[1]]
                    if name == "color"
                    else [f"{name}{i}" for i in range(arr.shape[1])]
                )
                props += [(c, code) for c in channels]
            else:
                props.append((name, code))
        return props

    def write(self, batch: PointsBatch) -> None:
        props = self._batch_props(batch)
        if self._schema is None:
            self._write_header(batch)
            self._schema = props
        elif props != self._schema:
            raise ValueError(
                f"batch schema {props} does not match the PLY header "
                f"{self._schema}"
            )
        rec = np.rec.fromarrays(
            [batch.position[:, 0].astype("<f8"),
             batch.position[:, 1].astype("<f8"),
             batch.position[:, 2].astype("<f8")]
            + [
                col
                for name, arr in batch.attributes.items()
                for col in (
                    [arr[:, i] for i in range(arr.shape[1])]
                    if arr.ndim == 2
                    else [arr]
                )
            ],
        )
        self._file.write(rec.tobytes())
        self.count += len(batch)

    def _write_header(self, batch: PointsBatch) -> None:
        lines = ["ply", "format binary_little_endian 1.0"]
        count_line = "element vertex "
        lines.append(count_line + "0".zfill(self._COUNT_WIDTH))
        props = [
            f"property {_PLY_TYPE_NAMES[code]} {name}"
            for name, code in self._batch_props(batch)
        ]
        header = "\n".join(lines + props + ["end_header"]) + "\n"
        prefix = "\n".join(lines[:2]) + "\n" + count_line
        self._count_pos = len(prefix)
        self._file.write(header.encode("ascii"))

    def close(self) -> None:
        if self._count_pos is not None:
            self._file.seek(self._count_pos)
            self._file.write(str(self.count).zfill(self._COUNT_WIDTH).encode("ascii"))
        self._file.close()

    def __enter__(self) -> "PlyStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def write_ply(path: str, batch: PointsBatch, offset: Optional[np.ndarray] = None) -> None:
    """Write a binary little-endian PLY: double x/y/z, then attributes in
    sorted name order (color expands to red/green/blue; multi-dim attributes
    get numbered suffixes, matching the reference writer's header —
    src/read_write/ply.rs:690-725)."""
    position = batch.position
    if offset is not None:
        position = position - offset

    fields: List[Tuple[str, str, np.ndarray]] = [
        ("x", "double", position[:, 0].astype("<f8")),
        ("y", "double", position[:, 1].astype("<f8")),
        ("z", "double", position[:, 2].astype("<f8")),
    ]
    for name, arr in batch.attributes.items():
        dstr = _PLY_TYPE_NAMES[np.dtype(arr.dtype).str.lstrip("<>=|")]
        if arr.ndim == 2:
            if name == "color":
                channel_names = ["red", "green", "blue", "alpha"]
            else:
                channel_names = [f"{name}{i}" for i in range(arr.shape[1])]
            for i in range(arr.shape[1]):
                fields.append((channel_names[i], dstr, arr[:, i]))
        else:
            fields.append((name, dstr, arr))

    header = ["ply", "format binary_little_endian 1.0"]
    if offset is not None:
        header.append("comment offset: {} {} {}".format(*offset))
    header.append(f"element vertex {len(batch)}")
    header += [f"property {d} {n}" for n, d, _ in fields]
    header.append("end_header")

    rec = np.rec.fromarrays(
        [f[2] for f in fields],
        dtype=np.dtype([(f"f{i}", "<" + np.dtype(f[2].dtype).str.lstrip("<>=|"))
                        for i, f in enumerate(fields)]),
    )
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
