"""The port's terrain streaming (viewer/terrain.py, a copy of the JAX
package's) against the JAX package on the cases of tests/test_terrain.py:
the tiled loader's stitched regions, the wraparound split, the moving
window's texture and snapshot after every move, the texels it re-uploads,
the on-disk round trip and the camera-following layer's windows and
heights all equal, byte for byte (tolerance 0: the same numpy copies)."""

import numpy as np
import pytest

from point_cloud_viewer_tpu.viewer import terrain as J
from point_cloud_viewer_tpu_torch.viewer import terrain as P


def _world_tiles(tile_size=16, extent_tiles=8):
    """Tiles whose texel value encodes its world coordinate (y*10000 + x)."""
    tiles = {}
    for ty in range(extent_tiles):
        for tx in range(extent_tiles):
            yy, xx = np.mgrid[0:tile_size, 0:tile_size]
            tiles[(tx, ty)] = (
                (yy + ty * tile_size) * 10000 + (xx + tx * tile_size)
            ).astype(np.float32)
    return tiles


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("region", [(10, 20, 30, 25), (1000, 1000, 4, 4),
                                    (-7, -3, 20, 40), (0, 0, 128, 128)])
def test_tiled_loader_matches_jax(region):
    got = P.TiledTextureLoader(16, _world_tiles(), fill_value=-1).load(*region)
    want = J.TiledTextureLoader(16, _world_tiles(), fill_value=-1).load(*region)
    _same(got, want)
    if region == (10, 20, 30, 25):
        assert got[0, 0] == 20 * 10000 + 10
        assert got[24, 29] == 44 * 10000 + 39
    if region == (1000, 1000, 4, 4):
        assert (got == -1).all()


@pytest.mark.parametrize("args", [(2, 3, 4, 4, 16), (14, 0, 4, 4, 16),
                                  (14, 15, 4, 4, 16), (31, 33, 16, 16, 32)])
def test_wraparound_regions_match_jax(args):
    got = [vars(r) for r in P.wraparound_regions(*args)]
    assert got == [vars(r) for r in J.wraparound_regions(*args)]
    assert sum(r["width"] * r["height"] for r in got) == args[2] * args[3]


@pytest.mark.parametrize("moves", [
    [(3, 0)], [(0, 3)], [(3, 3)], [(-3, -2)], [(5, -4)],
    [(1, 1), (2, -1), (-3, 4), (10, 10), (-7, 0)],
    [(40, 40)],
])
def test_moving_window_matches_jax(moves):
    windows = [M.MovingWindowTexture(
        32, M.TiledTextureLoader(16, _world_tiles(), fill_value=-1),
        origin=(8, 8)) for M in (P, J)]
    x, y = 8, 8
    for dx, dy in moves:
        x, y = x + dx, y + dy
        uploaded = [w.move_to(x, y) for w in windows]
        assert uploaded[0] == uploaded[1]
        _same(windows[0].texture, windows[1].texture)
        _same(windows[0].snapshot(), windows[1].snapshot())
        _same(windows[0].snapshot(),
              P.TiledTextureLoader(16, _world_tiles(), -1).load(x, y, 32, 32))


def test_moving_window_uploads_only_strips():
    win = P.MovingWindowTexture(
        32, P.TiledTextureLoader(16, _world_tiles(), fill_value=-1),
        origin=(8, 8))
    assert win.move_to(10, 8) == 2 * 32
    assert win.move_to(10, 11) == 3 * 32
    assert win.move_to(11, 12) == 32 + 31


@pytest.fixture(scope="module")
def terrain_dir(tmp_path_factory):
    """tests/test_terrain.py's on-disk set: 40 x 40 tiles of 8 texels at
    0.5 m from (100, 200), seeded heights and colours."""
    d = str(tmp_path_factory.mktemp("terrain"))
    ts = 8
    J.TerrainMetadata(tile_size=ts, world_origin_x=100.0,
                      world_origin_y=200.0, resolution_m=0.5).save(d)
    rng = np.random.default_rng(0)
    for tx in range(40):
        for ty in range(40):
            rng.random((ts, ts)).astype("<f4").tofile(
                J.tile_path(d, tx, ty, "height"))
            rng.integers(0, 255, (ts, ts, 4), dtype=np.uint8).tofile(
                J.tile_path(d, tx, ty, "color"))
    return d


def test_terrain_tiles_load_as_jax(terrain_dir, tmp_path):
    meta, heights, colors = P.load_terrain_tiles(terrain_dir)
    jmeta, jheights, jcolors = J.load_terrain_tiles(terrain_dir)
    assert vars(meta) == vars(jmeta)
    assert sorted(heights) == sorted(jheights) and len(heights) == 1600
    assert sorted(colors) == sorted(jcolors)
    for key in heights:
        _same(heights[key], jheights[key])
        _same(colors[key], jcolors[key])
    meta.save(str(tmp_path))
    assert (tmp_path / "meta.json").read_bytes() == open(
        f"{terrain_dir}/meta.json", "rb").read()
    assert P.tile_path("d", 3, 12, "color") == J.tile_path("d", 3, 12, "color")


@pytest.mark.parametrize("path", [[(80, 90)], [(80, 90), (95, 88), (60, 120)],
                                  [(10, 10), (200, 250)]])
def test_terrain_layer_follows_camera_as_jax(terrain_dir, path):
    """The camera-following windows after each move: loaded height and
    colour windows, texels re-uploaded and heights under the camera."""
    layers = [M.TerrainLayer(terrain_dir, window_size=32) for M in (P, J)]
    meta = layers[0].meta
    for gx, gy in path:
        xy = (meta.world_origin_x + gx * meta.resolution_m,
              meta.world_origin_y + gy * meta.resolution_m)
        uploaded = [layer.follow_camera(xy) for layer in layers]
        assert uploaded[0] == uploaded[1]
        assert layers[0].grid_pos(xy) == layers[1].grid_pos(xy)
        for attr in ("height_window", "color_window"):
            a, b = (getattr(layer, attr) for layer in layers)
            assert a.pos == b.pos
            _same(a.texture, b.texture)
            _same(a.snapshot(), b.snapshot())
        h = layers[0].height_at(xy)
        assert h == layers[1].height_at(xy)
        assert np.isfinite(h)
