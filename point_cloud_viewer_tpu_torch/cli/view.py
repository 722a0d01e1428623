"""CLI: the headless viewer of the port -- orbit a built octree, stream
nodes with adaptive LOD, and write the final frame as PNG (port of
point_cloud_viewer_tpu/cli/view.py; reference:
sdl_viewer/src/bin/sdl_viewer.rs).

Usage: python -m point_cloud_viewer_tpu_torch.cli.view OCTREE_DIR \
           [--device cuda] [--no-device_cull] [--frames 60] \
           [--screenshot viewer_frame.png]

The per-frame frustum cull + LOD selection runs on --device (cuda, the
default, or cpu for the kernel's plain version); --no-device_cull culls on
the host with the native library instead.  --gl and --window are not yet
ported.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("octree", help="Octree directory.")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--width", type=int, default=1280)
    parser.add_argument("--height", type=int, default=720)
    parser.add_argument("--screenshot", default="viewer_frame.png")
    parser.add_argument("--cache_size_mb", type=int, default=2000)
    parser.add_argument("--gl", action="store_true",
                        help="OpenGL rendering (not yet ported).")
    parser.add_argument(
        "--show_octree_nodes", action="store_true",
        help="Overlay node-cube outlines (the reference's box_drawer "
        "toggle, sdl_viewer 'o' key).",
    )
    parser.add_argument(
        "--device_cull", action=argparse.BooleanOptionalAction, default=True,
        help="Per-frame frustum cull + LOD selection on --device (node "
        "table resident on the device, one kernel launch per frame; the "
        "default); --no-device_cull culls with the host-native kernels.",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="PyTorch device of the cull: cuda (default) or cpu.",
    )
    parser.add_argument("--window", action="store_true",
                        help="Interactive SDL2 window (not yet ported).")
    args = parser.parse_args(argv)

    for flag in ("gl", "window"):
        if getattr(args, flag):
            print(f"error: --{flag} is not yet ported (see ROADMAP); the "
                  "headless loop runs without it.", file=sys.stderr)
            return 2

    from ..viewer.render_loop import run_headless

    stats = run_headless(
        args.octree,
        num_frames=args.frames,
        width=args.width,
        height=args.height,
        screenshot_path=args.screenshot,
        show_octree_nodes=args.show_octree_nodes,
        device_cull=args.device_cull,
        cache_size_mb=args.cache_size_mb,
        device=args.device,
    )
    print(
        f"Final frame: {stats.nodes_drawn}/{stats.visible_nodes} nodes, "
        f"{stats.points_drawn} points -> {args.screenshot}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
