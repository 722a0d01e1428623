"""CLI: the viewer of the port -- orbit a built octree headlessly, stream
nodes with adaptive LOD, and write the final frame as PNG, or open the
interactive SDL2 window (port of point_cloud_viewer_tpu/cli/view.py:1-91;
reference: sdl_viewer/src/bin/sdl_viewer.rs).

Usage: python -m point_cloud_viewer_tpu_torch.cli.view OCTREE_DIR \
           [--device cuda] [--no-device_cull] [--frames 60] \
           [--screenshot viewer_frame.png] [--gl] [--window]

The per-frame frustum cull + LOD selection runs on --device (cuda, the
default, or cpu for the kernel's plain version); --no-device_cull culls on
the host with the native library instead.  --gl draws through the OpenGL
pipeline (viewer/gl/) and fails when no GL driver exists; it never turns
into software rendering.  --window needs libSDL2 and a display.
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
    parser.add_argument(
        "--gl", action="store_true",
        help="Render through the real OpenGL pipeline (surfaceless EGL; "
        "GLSL shader-side decode) instead of the software rasterizer.",
    )
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
    parser.add_argument(
        "--window", action="store_true",
        help="Open an interactive SDL2 window with the reference's live "
        "key/mouse/joystick bindings (sdl_viewer/src/lib.rs:350-611). "
        "Needs libSDL2 and a display; without them this errors and the "
        "headless mode remains the default.",
    )
    args = parser.parse_args(argv)

    if args.gl:
        from ..viewer import gl

        if not gl.available():
            print("error: --gl needs an EGL/OpenGL driver, and no GL context "
                  "can be created here; rerun without --gl for the software "
                  "rasterizer.", file=sys.stderr)
            return 2

    if args.window:
        from ..viewer.input import sdl_available
        from ..viewer.sdl_shell import run_windowed

        if not sdl_available():
            print(
                "error: --window needs libSDL2 + a display, which this "
                "environment lacks; falling back is not implicit — rerun "
                "without --window for the headless loop.",
                file=sys.stderr,
            )
            return 2
        stats = run_windowed(
            args.octree,
            width=args.width,
            height=args.height,
            cache_size_mb=args.cache_size_mb,
            use_gl=args.gl,
            device_cull=args.device_cull,
            device=args.device,
        )
        print(
            f"Final frame: {stats.nodes_drawn}/{stats.visible_nodes} nodes, "
            f"{stats.points_drawn} points"
        )
        return 0

    from ..viewer.render_loop import run_headless

    stats = run_headless(
        args.octree,
        num_frames=args.frames,
        width=args.width,
        height=args.height,
        screenshot_path=args.screenshot,
        use_gl=args.gl,
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
