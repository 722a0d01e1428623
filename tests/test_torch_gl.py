"""The port's GL pipeline (point_cloud_viewer_tpu_torch/viewer/gl/) against
the JAX package's on the same driver (surfaceless EGL; llvmpipe on a
machine without a GPU driver): the scenes of tests/test_gl_renderer.py
drawn through both packages give the same frames, byte for byte
(tolerance 0: the same shaders and the same vertex bytes on one driver);
clipmap_mesh gives the JAX package's arrays; the GL frame and the software
rasterizer's agree by tests/test_gl_renderer.py's occupancy test (IoU of
8x8 blocks > 0.75, the JAX test's bound); and the GL viewer engine runs
end to end with its cull on device="cpu" (K5's plain version) and on the
host, its frames equal to the JAX GL engine's where both cull on the host.

Both packages keep a module-global EGL handle on the same libEGL.so.1;
each renderer makes its own context current before it draws
(PointsRendererGL.begin_frame, NodeBufferGL), so the two stacks share the
process.  Whether GL exists is decided in a fixture, never at import."""

import importlib
import time

import numpy as np
import pytest

from point_cloud_viewer_tpu.math.geometry import Isometry, Perspective

W, H = 200, 150


def _packages():
    """(port, JAX) namespaces of the GL path's modules."""
    out = []
    for pkg in ("point_cloud_viewer_tpu_torch", "point_cloud_viewer_tpu"):
        mods = {}
        for name in ("viewer.gl", "viewer.gl.renderer", "viewer.gl.terrain",
                     "viewer.gl.viewer", "viewer.terrain", "ops.codec",
                     "viewer.software_raster", "octree.octree"):
            mods[name.replace(".", "_")] = importlib.import_module(
                f"{pkg}.{name}")
        out.append(type("Mods", (), mods))
    return out


P, J = _packages()


@pytest.fixture(scope="module")
def gl_ok():
    if not (P.viewer_gl.available() and J.viewer_gl.available()):
        pytest.skip("no EGL/GL driver available")


@pytest.fixture(scope="module")
def renderers(gl_ok):
    """One renderer of each package, each on its own context."""
    out = []
    for M in (P, J):
        ctx = M.viewer_gl_renderer.GlContext(width=W, height=H)
        out.append(M.viewer_gl_renderer.PointsRendererGL(ctx))
    return out


def _look_at_clip(eye, at, fovy=1.0, aspect=W / H, near=0.1, far=1000.0):
    """tests/test_gl_renderer.py's look-at clip matrix."""
    z = np.asarray(eye, dtype=np.float64) - at
    z = z / np.linalg.norm(z)
    ref_up = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(ref_up, z)) > 0.99:
        ref_up = np.array([0.0, 1.0, 0.0])
    x = np.cross(ref_up, z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    iso = Isometry(np.stack([x, y, z], axis=1),
                   np.asarray(eye, dtype=np.float64))
    return (Perspective.from_fov(aspect, fovy, near, far).matrix
            @ iso.inverse().to_matrix4())


def _draw_once(r, node, clip, eye, count=None):
    r.begin_frame()
    r.draw_node(node, clip, camera_origin=eye, count=count)
    return r.read_frame()


def _encoding_scene(name):
    """The cluster at the cube centre of
    test_points_render_through_all_encodings, in one encoding."""
    dtype, scale = {"UINT8": (np.uint8, 255.0), "UINT16": (np.uint16, 65535.0),
                    "FLOAT32": (np.float32, 1.0),
                    "FLOAT64": (np.float64, 1.0)}[name]

    def scene(r, M):
        rng = np.random.default_rng(1)
        t = 0.5 + (rng.random((500, 3)) - 0.5) * 0.08
        colors = np.full((500, 3), (255, 32, 32), dtype=np.uint8)
        cube_min, edge = np.array([10.0, 20.0, 30.0]), 8.0
        node = r.make_node_buffer((t * scale).astype(dtype), colors,
                                  M.ops_codec.PositionEncoding[name],
                                  cube_min, edge)
        center = cube_min + edge / 2
        eye = center + np.array([0.0, -12.0, 0.0])
        img = _draw_once(r, node, _look_at_clip(eye, center), eye)
        node.destroy()
        return [img]

    def check(frames):
        img = frames[0]
        mid = img[50:100, 75:125]
        assert ((mid[:, :, 0] > 180) & (mid[:, :, 1] < 90)).sum() > 10
        corner = img[:20, :20]
        assert ((corner[:, :, 0] > 180) & (corner[:, :, 1] < 90)).sum() == 0

    return scene, check


def _clear_scene(r, M):
    r.begin_frame()
    return [r.read_frame()]


def _clear_check(frames):
    img = frames[0]
    assert img.shape == (H, W, 4)
    assert (img[:, :, 3] == 255).all() and np.unique(img[:, :, 0]).size == 1


def _planet_scene(r, M):
    """Two points 0.5 m apart at an ECEF-scale offset through the
    split-double program (test_f64_program_planet_scale_precision)."""
    base = np.array([4.5e6, 3.2e6, 2.8e6])
    world = np.stack([base, base + np.array([0.5, 0.0, 0.0])])
    cube_min, edge = base - 1.0, 4.0
    colors = np.array([[255, 0, 0], [0, 255, 0]], dtype=np.uint8)
    node = r.make_node_buffer((world - cube_min) / edge, colors,
                              M.ops_codec.PositionEncoding.FLOAT64, cube_min,
                              edge)
    eye = base + np.array([0.25, -4.0, 0.0])
    r.point_size = 3.0
    img = _draw_once(r, node, _look_at_clip(eye, base + [0.25, 0.0, 0.0]), eye)
    r.point_size = 2.0
    node.destroy()
    return [img]


def _planet_check(frames):
    img = frames[0]
    red = np.argwhere((img[:, :, 0] > 180) & (img[:, :, 1] < 90))
    green = np.argwhere((img[:, :, 1] > 180) & (img[:, :, 0] < 90))
    assert len(red) and len(green)
    assert abs(red[:, 1].mean() - green[:, 1].mean()) > 10


def _lod_boxes_scene(r, M):
    """A full draw, a 1/10 prefix draw and a box outline
    (test_lod_prefix_draw_and_boxes)."""
    rng = np.random.default_rng(2)
    n = 2000
    t = rng.random((n, 3))
    node = r.make_node_buffer(
        (t * 65535).astype(np.uint16), np.full((n, 3), 200, dtype=np.uint8),
        M.ops_codec.PositionEncoding.UINT16, np.zeros(3), 10.0)
    eye = np.array([5.0, -25.0, 5.0])
    clip = _look_at_clip(eye, np.array([5.0, 5.0, 5.0]))
    frames = [_draw_once(r, node, clip, eye),
              _draw_once(r, node, clip, eye, count=n // 10)]
    r.begin_frame()
    r.draw_boxes(np.zeros((1, 3)), np.array([10.0]), clip, camera_origin=eye)
    frames.append(r.read_frame())
    node.destroy()
    return frames


def _lod_boxes_check(frames):
    full, tenth, boxes = ((f[:, :, 0] > 100).sum() for f in frames)
    assert 0 < tenth < full
    b = frames[2]
    assert ((b[:, :, 0] > 200) & (b[:, :, 1] > 200) & (b[:, :, 2] < 60)
            ).sum() > 30


def _gamma_alpha_scene(r, M):
    """Mid-grey points at gamma 1.0 and 2.2, white points at alpha 1.0 and
    0.5 (test_gamma_and_alpha_uniforms, test_alpha_blending)."""
    eye = np.array([1.0, -3.0, 1.0])
    clip = _look_at_clip(eye, np.array([1.0, 1.0, 1.0]))
    frames = []
    for grey, knob, values in ((128, "gamma", (1.0, 2.2)),
                               (255, "alpha", (1.0, 0.5))):
        n = 200 if knob == "gamma" else 300
        node = r.make_node_buffer(
            (np.full((n, 3), 0.5) * 255).astype(np.uint8),
            np.full((n, 3), grey, dtype=np.uint8),
            M.ops_codec.PositionEncoding.UINT8, np.zeros(3), 2.0)
        for v in values:
            setattr(r, knob, v)
            frames.append(_draw_once(r, node, clip, eye))
        setattr(r, knob, 1.0)
        node.destroy()
    return frames


def _gamma_alpha_check(frames):
    def brightest(img):
        mask = img[:, :, 0] != img[0, 0, 0]
        return int(img[:, :, 0][mask].max()) if mask.any() else 0

    g1, g22, opaque, half = (brightest(f) for f in frames)
    assert 0 < g1 < g22
    assert opaque >= 250 and 100 <= half <= 180


def _terrain_dir(tmp, hole=None):
    """tests/test_gl_renderer.py's flat red terrain: 8 x 8 tiles of 16
    texels at 1 m, height 2, `hole` left off the disk."""
    import os

    from point_cloud_viewer_tpu.viewer.terrain import (
        TerrainMetadata, tile_path)

    d = str(tmp / ("holed" if hole else "full"))
    os.makedirs(d, exist_ok=True)
    ts = 16
    TerrainMetadata(tile_size=ts, world_origin_x=0.0, world_origin_y=0.0,
                    resolution_m=1.0).save(d)
    for tx in range(8):
        for ty in range(8):
            if (tx, ty) == hole:
                continue
            np.full((ts, ts), 2.0, dtype="<f4").tofile(
                tile_path(d, tx, ty, "height"))
            c = np.zeros((ts, ts, 4), dtype=np.uint8)
            c[..., 0] = 200
            c[..., 3] = 255
            c.tofile(tile_path(d, tx, ty, "color"))
    return d


def _terrain_scene(hole):
    def scene(r, M, tmp):
        d = _terrain_dir(tmp, hole)
        layer = M.viewer_terrain.TerrainLayer(d, window_size=64)
        if hole:
            drawer = M.viewer_gl_terrain.TerrainDrawerGL(
                r.ctx, layer, num_levels=2, grid_size=63)
            center = np.array([72.0, 72.0, 2.0])
            eye = center + np.array([0.0, -1.0, 60.0])
        else:
            drawer = M.viewer_gl_terrain.TerrainDrawerGL(
                r.ctx, layer, num_levels=3, grid_size=31)
            center = np.array([64.0, 64.0, 2.0])
            eye = center + np.array([0.0, -30.0, 25.0])
        r.begin_frame()
        drawer.draw(_look_at_clip(eye, center), camera_xy=center[:2])
        return [r.read_frame()]

    def check(frames):
        img = frames[0]
        red = (img[:, :, 0] > 120) & (img[:, :, 1] < 80)
        assert red.sum() > 1000
        if hole:
            assert red[int(0.45 * H):int(0.55 * H),
                       int(0.45 * W):int(0.55 * W)].sum() == 0

    return scene, check


_SCENES = {
    "clear": (_clear_scene, _clear_check),
    **{f"encoding_{e}": _encoding_scene(e)
       for e in ("UINT8", "UINT16", "FLOAT32", "FLOAT64")},
    "f64_planet_scale": (_planet_scene, _planet_check),
    "lod_prefix_and_boxes": (_lod_boxes_scene, _lod_boxes_check),
    "gamma_and_alpha": (_gamma_alpha_scene, _gamma_alpha_check),
    "terrain_clipmap": _terrain_scene(None),
    "terrain_sparse_hole": _terrain_scene((4, 4)),
}


@pytest.mark.parametrize("name", sorted(_SCENES))
def test_gl_frames_byte_equal_to_jax(renderers, name, tmp_path):
    scene, check = _SCENES[name]
    frames = []
    for r, M, side in zip(renderers, (P, J), ("port", "jax")):
        args = (tmp_path / side,) if name.startswith("terrain") else ()
        frames.append(scene(r, M, *args))
    mine, theirs = frames
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.shape == b.shape == (H, W, 4)
        assert a.tobytes() == b.tobytes()
    check(mine)


@pytest.mark.parametrize("grid,ring_only", [(8, False), (8, True),
                                            (31, True), (63, False)])
def test_clipmap_mesh_equals_jax(grid, ring_only):
    got = P.viewer_gl_terrain.clipmap_mesh(grid, ring_only=ring_only)
    want = J.viewer_gl_terrain.clipmap_mesh(grid, ring_only=ring_only)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    verts, idx = got
    assert verts.shape == ((grid + 1) ** 2, 2)
    assert idx.max() == (grid + 1) ** 2 - 1
    if grid == 8:  # the JAX test's counts: the central 4x4 quads removed
        assert len(idx) == (64 - 16 * ring_only) * 6
    tri = verts[idx.reshape(-1, 3)]
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    assert (np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) > 0).all()


def test_gl_agrees_with_software_rasterizer(gl_ok):
    """The port's GL frame and its software rasterizer on one scene:
    coarse occupancy (8x8 blocks) IoU > 0.75, as the JAX test requires."""
    rng = np.random.default_rng(7)
    n = 4_000
    t = rng.random((n, 3))
    cube_min, edge = np.array([5.0, 5.0, 0.0]), 12.0
    colors = np.full((n, 3), 230, dtype=np.uint8)
    eye = cube_min + np.array([6.0, -20.0, 14.0])
    clip = _look_at_clip(eye, cube_min + edge / 2, aspect=160 / 120)
    sw = P.viewer_software_raster.rasterize_points(
        cube_min + t * edge, colors, clip, 160, 120)
    r = P.viewer_gl_renderer.PointsRendererGL(
        P.viewer_gl_renderer.GlContext(width=160, height=120))
    node = r.make_node_buffer(t.astype(np.float32), colors,
                              P.ops_codec.PositionEncoding.FLOAT32,
                              cube_min, edge)
    r.point_size = 1.0
    hw = _draw_once(r, node, clip, eye)
    node.destroy()

    def occupancy(img):
        mask = np.any(img[:, :, :3] != img[0, 0, :3], axis=-1)
        return mask[:120, :160].reshape(15, 8, 20, 8).any(axis=(1, 3))

    occ_sw, occ_gl = occupancy(sw), occupancy(hw)
    union = (occ_sw | occ_gl).sum()
    assert union > 20
    assert (occ_sw & occ_gl).sum() / union > 0.75


@pytest.fixture(scope="module")
def cloud(tmp_path_factory):
    """tests/test_gl_renderer.py's 60,000-point cloud, built by the port."""
    from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
    from point_cloud_viewer_tpu_torch.octree.builder import build_octree

    rng = np.random.default_rng(11)
    n = 60_000
    pos = rng.random((n, 3)) * np.array([30.0, 30.0, 10.0])
    col = (pos / np.array([30, 30, 10]) * 255).astype(np.uint8)
    out = str(tmp_path_factory.mktemp("glcloud") / "oct")
    build_octree(out, 0.01, PointsBatch(position=pos,
                                        attributes={"color": col}),
                 device="cpu")
    return out


def _settled_frame(renderer, matrix, deadline_s=60.0):
    """Queue one camera matrix and draw until every visible node is drawn
    (a deadline, not a race against the visible-node thread)."""
    renderer.camera_changed(matrix)
    deadline = time.perf_counter() + deadline_s
    while True:
        stats, image = renderer.draw(matrix, moving=False, render=True)
        if stats.visible_nodes and stats.nodes_drawn == stats.visible_nodes:
            return stats, image
        assert time.perf_counter() < deadline, stats
        time.sleep(0.02)


def _orbit_matrix(octree, width, height):
    from point_cloud_viewer_tpu_torch.viewer.camera import Camera

    camera = Camera(width, height)
    center = octree.bounding_box.center()
    diag = float(np.linalg.norm(octree.bounding_box.diag()))
    camera.position = center + diag * np.array([0.6, -0.8, 0.5])
    camera.theta, camera.phi = 0.6, np.pi / 3
    return camera.world_to_gl()


@pytest.mark.parametrize("cull", ["device_cpu", "host"])
def test_gl_viewer_engine_end_to_end(gl_ok, cloud, cull):
    """GlPointCloudRenderer over the cloud, one orbit matrix, drawn until
    settled: the cloud covers the frame; with the host cull its frame
    equals the JAX GL engine's (the same native cull, the same draws)."""
    octree = P.octree_octree.Octree.from_directory(cloud)
    matrix = _orbit_matrix(octree, 320, 240)
    kwargs = ({"device": "cpu"} if cull == "device_cpu"
              else {"device_cull": False})
    r = P.viewer_gl_viewer.GlPointCloudRenderer(octree, width=320,
                                               height=240, **kwargs)
    try:
        stats, image = _settled_frame(r, matrix)
    finally:
        r.shutdown()
    assert stats.points_drawn > 0
    assert image.shape == (240, 320, 4)
    assert np.any(image != image[0, 0], axis=-1).sum() > 500
    if cull == "host":
        theirs = J.viewer_gl_viewer.GlPointCloudRenderer(
            J.octree_octree.Octree.from_directory(cloud), width=320,
            height=240)
        try:
            want_stats, want = _settled_frame(theirs, matrix)
        finally:
            theirs.shutdown()
        assert (stats.visible_nodes, stats.points_drawn) == (
            want_stats.visible_nodes, want_stats.points_drawn)
        assert image.tobytes() == want.tobytes()


def test_run_headless_gl_end_to_end(gl_ok, cloud, tmp_path):
    """run_headless(use_gl=True, device="cpu"): paced frames, the final
    frame written as PNG at the asked size; drawn nodes are required of
    the settled engine test above, not of this paced loop."""
    from PIL import Image

    from point_cloud_viewer_tpu_torch.viewer.render_loop import run_headless

    shot = str(tmp_path / "gl_frame.png")
    stats = run_headless(cloud, num_frames=12, width=320, height=240,
                         screenshot_path=shot, use_gl=True, device="cpu",
                         frame_pacing_s=0.02)
    assert stats.visible_nodes >= stats.nodes_drawn >= 0
    assert np.asarray(Image.open(shot)).shape == (240, 320, 4)
