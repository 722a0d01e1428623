"""point_cloud_viewer_tpu_torch — the PyTorch + CUDA port of
point_cloud_viewer_tpu for NVIDIA Hopper (H100).

The JAX package stays beside it as the reference.  Its layout is mirrored
here module by module; every Pallas kernel becomes a hand-written CUDA
kernel under `csrc/`, built with nvcc on first use (`ops/_ext.py`), with a
plain PyTorch version beside it that CPU tensors take.  This package
imports torch and nothing of the JAX package: the host layers it needs
(core, io, protos, math, octree.node_id, octree.octree, octree.traversal,
ops.codec, native, query.location, s2_cells, utils.progress,
utils.extension, viewer.camera, viewer.software_raster, the x-ray quadtree
algebra, meta, colormaps, merge and inpaint, the GL pipeline, terrain, the
SDL shell's input mappings, both web servers and the host tools' CLIs) are
its own copies, each citing the source lines it was copied from.  Its
`tools/` holds the twins of the JAX package's randomized campaigns.

The package root exports the JAX root's twelve names (point_cloud_viewer_
tpu/__init__.py:23-79, copied unchanged): four constants, and eight
classes and functions resolved on first use, so importing the package
imports no torch.
"""

__version__ = "0.1.0"

from .core.constants import (  # noqa: F401 — public constants
    CURRENT_VERSION,
    META_FILENAME,
    NUM_POINTS_PER_BATCH,
    MAX_POINTS_PER_NODE,
)

__all__ = [
    "CURRENT_VERSION",
    "META_FILENAME",
    "NUM_POINTS_PER_BATCH",
    "MAX_POINTS_PER_NODE",
    "PointsBatch",
    "build_octree",
    "build_octree_streaming",
    "build_s2_cloud",
    "Octree",
    "S2Cells",
    "PointCloudClient",
    "PointQuery",
]


def __getattr__(name):  # lazy re-exports keep import light
    if name == "PointsBatch":
        from .core.points_batch import PointsBatch

        return PointsBatch
    if name == "build_octree":
        from .octree.builder import build_octree

        return build_octree
    if name == "build_octree_streaming":
        from .octree.streaming import build_octree_streaming

        return build_octree_streaming
    if name == "build_s2_cloud":
        from .s2_cells.splitter import build_s2_cloud

        return build_s2_cloud
    if name == "Octree":
        from .octree.octree import Octree

        return Octree
    if name == "S2Cells":
        from .s2_cells.container import S2Cells

        return S2Cells
    if name == "PointCloudClient":
        from .query.client import PointCloudClient

        return PointCloudClient
    if name == "PointQuery":
        from .query.point_query import PointQuery

        return PointQuery
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
