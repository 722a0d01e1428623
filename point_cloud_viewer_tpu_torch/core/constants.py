"""Framework-wide constants (copy of point_cloud_viewer_tpu/core/
constants.py:1-20, unchanged).

These mirror the reference's operational constants so that on-disk data and
streaming behavior are interchangeable (reference: src/lib.rs:48-52,
src/octree/generation.rs:37).
"""

# On-disk meta format version we write.  Versions 9..13 can be read
# (reference: src/lib.rs:40-48 documents the migration chain).
CURRENT_VERSION: int = 13

# File name of the serialized Meta proto inside a point cloud directory.
META_FILENAME: str = "meta.pb"

# Number of points per streamed batch (reference: src/lib.rs:52).
NUM_POINTS_PER_BATCH: int = 500_000

# Nodes with more points than this are split during octree construction
# (reference: src/octree/generation.rs:37).
MAX_POINTS_PER_NODE: int = 100_000
