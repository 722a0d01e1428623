"""point_cloud_viewer_tpu_torch — the PyTorch + CUDA port of
point_cloud_viewer_tpu for NVIDIA Hopper (H100).

The JAX package stays beside it as the reference.  Its layout is mirrored
here module by module; every Pallas kernel becomes a hand-written CUDA
kernel under `csrc/`, built with nvcc on first use (`ops/_ext.py`), with a
plain PyTorch version beside it that CPU tensors take.  This package
imports torch and nothing of the JAX package: the host layers it needs
(core, io, protos, math, octree.node_id, octree.octree, ops.codec, native,
query.location, s2_cells, utils.progress, utils.extension, viewer.camera,
viewer.software_raster, the x-ray quadtree algebra, meta, colormaps,
merge and inpaint, the GL pipeline, terrain, the SDL shell's input
mappings and both web servers) are its own copies, each citing the
source lines it was copied from.
"""

__version__ = "0.1.0"
