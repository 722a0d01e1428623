"""PointsBatch — the structure-of-arrays point container (copy of
point_cloud_viewer_tpu/core/points_batch.py:21-106, trimmed to the methods
the port calls).

The framework's unit of streaming: positions of shape (N, 3) float64 plus a
dict of per-point attribute arrays (reference: src/lib.rs:100-191).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import numpy as np

from .attributes import AttributeDataType


@dataclass
class PointsBatch:
    """Positions (N, 3) float64 + named SoA attribute arrays ((N,) or (N,3)).

    Attribute iteration order is deterministic (sorted by name) to mirror the
    reference's BTreeMap semantics (reference: src/lib.rs:104).
    """

    position: np.ndarray
    attributes: Dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.position = np.asarray(self.position, dtype=np.float64)
        if self.position.ndim != 2 or self.position.shape[1] != 3:
            raise ValueError(f"position must be (N, 3), got {self.position.shape}")
        # Keep deterministic (sorted) attribute order.
        self.attributes = {k: np.asarray(self.attributes[k]) for k in sorted(self.attributes)}
        n = len(self.position)
        for name, arr in self.attributes.items():
            if len(arr) != n:
                raise ValueError(
                    f"attribute '{name}' has {len(arr)} entries, expected {n}"
                )

    def __len__(self) -> int:
        return len(self.position)

    @property
    def attribute_names(self) -> List[str]:
        return list(self.attributes)

    def data_types(self) -> Dict[str, AttributeDataType]:
        return {k: AttributeDataType.from_array(v) for k, v in self.attributes.items()}

    def retain(self, keep: np.ndarray) -> "PointsBatch":
        """Return a batch with only the rows where `keep` is True."""
        keep = np.asarray(keep, dtype=bool)
        return PointsBatch(
            position=self.position[keep],
            attributes={k: v[keep] for k, v in self.attributes.items()},
        )

    def take(self, indices: np.ndarray) -> "PointsBatch":
        """Return a batch gathered at `indices` (row order preserved)."""
        return PointsBatch(
            position=self.position[indices],
            attributes={k: v[indices] for k, v in self.attributes.items()},
        )

    def slice(self, start: int, stop: int) -> "PointsBatch":
        return PointsBatch(
            position=self.position[start:stop],
            attributes={k: v[start:stop] for k, v in self.attributes.items()},
        )

    def split_off(self, at: int) -> "PointsBatch":
        """Split this batch in place at `at`; returns the tail."""
        tail = self.slice(at, len(self))
        self.position = self.position[:at]
        self.attributes = {k: v[:at] for k, v in self.attributes.items()}
        return tail

    @staticmethod
    def concatenate(batches: Iterable["PointsBatch"]) -> "PointsBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return PointsBatch(position=np.empty((0, 3), np.float64))
        names = batches[0].attribute_names
        for b in batches[1:]:
            if b.attribute_names != names:
                raise ValueError(
                    f"attribute mismatch: {b.attribute_names} vs {names}"
                )
        return PointsBatch(
            position=np.concatenate([b.position for b in batches]),
            attributes={
                k: np.concatenate([b.attributes[k] for b in batches]) for k in names
            },
        )


def as_points_batch(data):
    """`data` as this package's PointsBatch when it is one batch, else None
    (an iterable of batches).  A batch is recognised by its two fields, so
    the JAX package's PointsBatch reads the same way; its arrays are not
    copied."""
    if isinstance(data, PointsBatch):
        return data
    if hasattr(data, "position") and hasattr(data, "attributes"):
        return PointsBatch(position=data.position, attributes=data.attributes)
    return None
