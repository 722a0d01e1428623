"""CLI: build an octree from a PLY file with the tree derivation on a
PyTorch device (port of point_cloud_viewer_tpu/cli/build_octree.py;
reference: src/bin/build_octree.rs).

Usage: python -m point_cloud_viewer_tpu_torch.cli.build_octree INPUT.ply \
           --output_directory DIR [--device cuda] [--resolution 0.001] \
           [--no-use_device] [--mesh N] \
           [--streaming [--bucket_levels 2] [--spill_directory SPILL]]

The tree derivation runs on --device (--use_device, the default) or on the
host (--no-use_device), in core or out of core (--streaming).  --mesh N
shards it over the first N devices of --device's type
(parallel/mesh.make_mesh: N cards, truncated to those visible, or N CPU
shards with --device cpu); it does not combine with --streaming.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from ..utils.progress import timed_phase


def main(argv=None, phase_times: Optional[dict] = None) -> int:
    """`phase_times`: when given, accumulates the build's wall seconds per
    phase (they are printed either way), and under "total" the wall time of
    the whole command."""
    times = {} if phase_times is None else phase_times
    with timed_phase(times, "total"):
        result, output_directory = _build(argv, times)
        print(
            f"Built octree with {result.num_points} points in "
            f"{len(result.nodes)} nodes (depth cap {result.depth_cap}) "
            f"at {output_directory}"
        )
    print("phase seconds: " + json.dumps(times))
    return 0


def _build(argv, times: dict):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("input", help="PLY file to parse for points")
    parser.add_argument("--output_directory", required=True)
    parser.add_argument(
        "--resolution",
        type=float,
        default=0.001,
        help="Minimal precision that this point cloud should have (meters).",
    )
    parser.add_argument(
        "--attributes",
        nargs="*",
        default=None,
        help="Attributes to store (default: all present in the input).",
    )
    parser.add_argument(
        "--use_device",
        action=argparse.BooleanOptionalAction,
        default=True,
        help="Run the tree derivation on --device (the default); "
        "--no-use_device builds on the host.",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="PyTorch device of the derivation: cuda (default) or cpu "
        "(unused with --no-use_device).",
    )
    parser.add_argument(
        "--mesh",
        type=int,
        default=0,
        metavar="N",
        help="Shard the derivation over the first N devices of --device's "
        "type (multi-device build; output is byte-identical to one "
        "device's). --use_device is then not read.",
    )
    parser.add_argument(
        "--streaming",
        action="store_true",
        help="Bounded-memory out-of-core build (for clouds larger than RAM).",
    )
    parser.add_argument("--bucket_levels", type=int, default=2)
    parser.add_argument(
        "--spill_directory",
        default=None,
        help="Spill directory for --streaming builds; giving one makes the "
        "build RESUMABLE (re-run the same command after a crash to "
        "continue from the last finished bucket).",
    )
    parser.add_argument(
        "--num_threads", type=int, default=None,
        help="Node-file write pool size — set as high as possible for "
        "SSDs (reference build_octree.rs:36-38; default: cpu-derived).",
    )
    args = parser.parse_args(argv)

    if args.streaming and args.mesh:
        parser.error(
            "--mesh is not supported with --streaming (the out-of-core "
            "builder shards over disk buckets instead of devices)"
        )
    if args.spill_directory and not args.streaming:
        parser.error("--spill_directory requires --streaming")
    if args.num_threads is not None:
        if args.num_threads <= 0:
            parser.error("--num_threads must be positive")
        import os

        os.environ["PCV_WRITE_THREADS"] = str(args.num_threads)

    if args.streaming:
        from ..io.ply import PlyReader
        from ..octree.streaming import build_octree_streaming

        result = build_octree_streaming(
            args.output_directory,
            args.resolution,
            PlyReader(args.input),
            attributes=args.attributes,
            bucket_levels=args.bucket_levels,
            spill_directory=args.spill_directory,
            use_device=args.use_device,
            phase_times=times,
            device=args.device,
        )
    else:
        from ..octree.builder import build_octree_from_file

        mesh = None
        if args.mesh:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(args.mesh, device=args.device)
        result = build_octree_from_file(
            args.output_directory,
            args.resolution,
            args.input,
            attributes=args.attributes,
            use_device=args.use_device,
            mesh=mesh,
            phase_times=times,
            device=args.device,
        )
    return result, args.output_directory


if __name__ == "__main__":
    sys.exit(main())
