"""Hole inpainting for X-ray leaf tiles (reference: xray/src/inpaint.rs).

Pipeline preserved from the reference:

1. each leaf tile is enlarged 2x by stitching half-tiles from its 8
   neighbors (so inpainting can sample across tile borders),
2. holes are detected by a morphological close (LInf, radius
   inpaint_distance_px) on the alpha channel — only holes up to that radius
   are filled, open borders stay transparent,
3. the fill itself: the reference runs a texture-synthesis session
   (inpaint.rs:24-44); here `patchmatch_fill` — a PatchMatch-style
   nearest-patch synthesis — fills holes with copied texture, the same
   family of algorithm without the heavyweight dependency
   (`diffusion_fill`, a smooth neighbor-averaging alternative, is kept
   for comparison/tests but is not used by `inpaint_image`),
4. overlapping inpainted tiles are blended with linear interpolation along
   the right/bottom seams, scheduled in an even/odd checkerboard so no two
   neighbors are written concurrently (inpaint.rs:237-255),
5. the original tile is cut back out of the enlarged image.

Copy of point_cloud_viewer_tpu/xray/inpaint.py:1-372, unchanged.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional

import numpy as np
from PIL import Image
from scipy import ndimage

from .build import image_path
from .quadtree import Direction, QuadNodeId, SpatialNodeId


def _close_alpha(alpha: np.ndarray, radius: int) -> np.ndarray:
    """Morphological close with an LInf (square) structuring element."""
    size = 2 * radius + 1
    dilated = ndimage.grey_dilation(alpha, size=(size, size), mode="constant", cval=0)
    return ndimage.grey_erosion(dilated, size=(size, size), mode="constant", cval=255)


def diffusion_fill(
    image: np.ndarray, fill_mask: np.ndarray, valid_mask: np.ndarray, iterations: int
) -> np.ndarray:
    """Fill `fill_mask` pixels by iteratively averaging valid neighbors."""
    img = image.astype(np.float32)
    rgb = img[:, :, :3]
    weight = valid_mask.astype(np.float32)
    rgb = rgb * weight[:, :, None]
    kernel = np.array([[0.5, 1.0, 0.5], [1.0, 0.0, 1.0], [0.5, 1.0, 0.5]], np.float32)
    filled = valid_mask.copy()
    for _ in range(iterations):
        wsum = ndimage.convolve(weight, kernel, mode="constant")
        csum = np.stack(
            [ndimage.convolve(rgb[:, :, c], kernel, mode="constant") for c in range(3)],
            axis=-1,
        )
        newly = fill_mask & ~filled & (wsum > 0)
        if not newly.any():
            break
        rgb[newly] = csum[newly] / wsum[newly, None]
        weight[newly] = 1.0
        filled |= newly
    out = image.copy()
    write = fill_mask & filled & ~valid_mask
    out[write, :3] = np.clip(rgb[write], 0, 255).astype(np.uint8)
    out[write, 3] = 255
    return out


def patchmatch_fill(
    image: np.ndarray,
    fill_mask: np.ndarray,
    valid_mask: np.ndarray,
    patch: int = 7,
    random_candidates: int = 6,
    seed: int = 0,
) -> np.ndarray:
    """Texture-synthesis hole fill: every hole pixel copies its color from
    the center of the valid patch that best matches its neighborhood, so
    textures CONTINUE into the hole instead of smearing.

    The reference fills holes with a texture_synthesis Session
    (xray/src/inpaint.rs:24-44); this is a deterministic equivalent built
    from the same ingredients as PatchMatch (Barnes et al., SIGGRAPH 2009):
    onion-peel ordering (boundary inward, so each pixel is synthesized from
    already-real texture), coherence candidates (shifted matches of filled
    neighbors — this carries texture phase into the hole), and a few seeded
    random candidates to escape local minima."""
    holes_mask = fill_mask & ~valid_mask
    out = image.copy()
    if not holes_mask.any():
        return out
    src_pool = np.argwhere(valid_mask)
    if len(src_pool) == 0:
        return out
    h, w = valid_mask.shape
    rng = np.random.default_rng(seed)

    est = image[:, :, :3].astype(np.float32)
    filled = valid_mask.copy()
    # nnf[y, x] = source pixel each filled pixel was copied from (valid
    # pixels map to themselves).
    nnf = np.stack(
        np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), axis=-1
    )

    pr = patch // 2
    offs = [(dy, dx) for dy in range(-pr, pr + 1) for dx in range(-pr, pr + 1)]
    neigh8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]

    # Onion-peel rings: distance (in hole pixels) from the valid boundary.
    dist = ndimage.distance_transform_cdt(~valid_mask, metric="chessboard")

    for ring in range(1, int(dist[holes_mask].max()) + 1):
        sel = holes_mask & (dist == ring)
        if not sel.any():
            continue
        pix = np.argwhere(sel)
        m = len(pix)
        ty, tx = pix[:, 0], pix[:, 1]

        def cost_of(cand):
            sy = np.clip(cand[:, 0], 0, h - 1)
            sx = np.clip(cand[:, 1], 0, w - 1)
            c = np.zeros(m, dtype=np.float32)
            for dy, dx in offs:
                tyy = np.clip(ty + dy, 0, h - 1)
                txx = np.clip(tx + dx, 0, w - 1)
                syy = np.clip(sy + dy, 0, h - 1)
                sxx = np.clip(sx + dx, 0, w - 1)
                wgt = filled[tyy, txx].astype(np.float32)
                d = est[tyy, txx] - est[syy, sxx]
                c += wgt * np.einsum("ij,ij->i", d, d)
                # Prefer sources whose own neighborhood is real texture.
                c += np.where(valid_mask[syy, sxx], 0.0, 1e3).astype(np.float32)
            # Source center must be real texture.
            return np.where(valid_mask[sy, sx], c, np.float32(np.inf))

        best = np.full(m, np.inf, dtype=np.float32)
        best_src = np.zeros((m, 2), dtype=np.int64)

        def consider(cand):
            nonlocal best, best_src
            cand = np.clip(cand, 0, [h - 1, w - 1])
            c = cost_of(cand)
            better = c < best
            best_src[better] = cand[better]
            best[better] = c[better]

        # Coherence: continue the texture the filled neighbors came from.
        # Two candidates per neighbor: the phase-preserving shift of the
        # neighbor's own source (classic coherence), and the neighbor's
        # source itself (plain boundary extension — for a valid neighbor
        # the shifted candidate is the hole pixel itself and is rejected,
        # so this is what lets ring 1 lock onto the boundary texture).
        for dy, dx in neigh8:
            ny = np.clip(ty + dy, 0, h - 1)
            nx = np.clip(tx + dx, 0, w - 1)
            has = filled[ny, nx]
            fallback = src_pool[0][None, :]
            consider(np.where(has[:, None], nnf[ny, nx] - (dy, dx), fallback))
            consider(np.where(has[:, None], nnf[ny, nx], fallback))
        # Seeded random exploration.
        for _ in range(random_candidates):
            consider(src_pool[rng.integers(0, len(src_pool), m)])

        est[ty, tx] = est[best_src[:, 0], best_src[:, 1]]
        nnf[ty, tx] = best_src
        filled[ty, tx] = True
        out[ty, tx, :3] = image[best_src[:, 0], best_src[:, 1], :3]
        out[ty, tx, 3] = 255

    return out


def inpaint_image(image: np.ndarray, distance_px: int) -> np.ndarray:
    """Fill holes of radius <= distance_px; big open areas stay transparent
    (reference inpaint(), inpaint.rs:24-44)."""
    alpha = image[:, :, 3]
    closed = _close_alpha(alpha, distance_px)
    valid = alpha >= 128
    # Pixels that the close filled in = holes small enough to inpaint.
    fill = (closed.astype(np.int16) - alpha.astype(np.int16)) > 0
    return patchmatch_fill(image, fill | valid, valid)


class _TileSet:
    def __init__(self, directory: str, node_ids: Iterable[QuadNodeId]) -> None:
        self.directory = directory
        self.by_spatial: Dict[SpatialNodeId, QuadNodeId] = {
            n.to_spatial(): n for n in node_ids
        }

    def load(self, spatial: Optional[SpatialNodeId]) -> Optional[np.ndarray]:
        # Load by on-disk path, NOT restricted to the leaf set: the
        # reference stitches from any tile present in the directory
        # (inpaint.rs:64-70 image_from_path), which is what lets imported
        # adjacent-quadtree leaf tiles contribute to border inpainting.
        if spatial is None:
            return None
        node_id = self.by_spatial.get(spatial) or spatial.to_node_id()
        path = image_path(self.directory, node_id)
        if not os.path.exists(path):
            return None
        return np.asarray(Image.open(path).convert("RGBA"))

    def inpaint_path(self, spatial: SpatialNodeId) -> str:
        return image_path(self.directory, self.by_spatial[spatial]) + ".inpaint.png"


def _stitched(tiles: _TileSet, spatial: SpatialNodeId) -> Optional[np.ndarray]:
    """2x enlarged tile: the tile centered, surrounded by neighbor halves
    (reference: inpaint.rs:90-121).  Image y is north-up-flipped, so the
    'Top' neighbor contributes the BOTTOM of its image to our top band."""
    current = tiles.load(spatial)
    if current is None:
        return None
    h, w = current.shape[0] // 2, current.shape[1] // 2
    big = np.zeros((4 * h, 4 * w, 4), dtype=np.uint8)
    big[h : 3 * h, w : 3 * w] = current

    def paste(direction, from_x, from_y, width, height, to_x, to_y):
        neighbor = tiles.load(spatial.neighbor(direction))
        if neighbor is not None:
            big[to_y : to_y + height, to_x : to_x + width] = neighbor[
                from_y : from_y + height, from_x : from_x + width
            ]

    paste(Direction.TOP_LEFT, w, h, w, h, 0, 0)
    paste(Direction.TOP, 0, h, 2 * w, h, w, 0)
    paste(Direction.TOP_RIGHT, 0, h, w, h, 3 * w, 0)
    paste(Direction.RIGHT, 0, 0, w, 2 * h, 3 * w, h)
    paste(Direction.BOTTOM_RIGHT, 0, 0, w, h, 3 * w, 3 * h)
    paste(Direction.BOTTOM, 0, 0, 2 * w, h, w, 3 * h)
    paste(Direction.BOTTOM_LEFT, w, 0, w, h, 0, 3 * h)
    paste(Direction.LEFT, w, 0, w, 2 * h, 0, h)
    return big


def _interpolate_seam(tiles: _TileSet, spatial: SpatialNodeId, direction: Direction) -> None:
    neighbor_spatial = spatial.neighbor(direction)
    if neighbor_spatial is None or neighbor_spatial not in tiles.by_spatial:
        return
    cur_path = tiles.inpaint_path(spatial)
    nb_path = tiles.inpaint_path(neighbor_spatial)
    if not (os.path.exists(cur_path) and os.path.exists(nb_path)):
        return
    cur = np.asarray(Image.open(cur_path)).astype(np.float32)
    nb = np.asarray(Image.open(nb_path)).astype(np.float32)
    hh, ww = cur.shape[0], cur.shape[1]
    if direction == Direction.RIGHT:
        w = ww // 2
        cur_view = cur[:, w:]
        nb_view = nb[:, :w]
        weight = (np.arange(w, dtype=np.float32) / (w - 1))[None, :, None]
    elif direction == Direction.BOTTOM:
        h = hh // 2
        # Image y is flipped: our geographic 'bottom' is the lower half of
        # our image and the TOP half of the neighbor's image.
        cur_view = cur[h:, :]
        nb_view = nb[:h, :]
        weight = (np.arange(h, dtype=np.float32) / (h - 1))[:, None, None]
    else:
        raise NotImplementedError(direction)
    blended = np.round(nb_view * weight + cur_view * (1.0 - weight)).astype(np.uint8)
    cur_out = cur.astype(np.uint8)
    nb_out = nb.astype(np.uint8)
    if direction == Direction.RIGHT:
        cur_out[:, ww // 2 :] = blended
        nb_out[:, : ww // 2] = blended
    else:
        cur_out[hh // 2 :, :] = blended
        nb_out[: hh // 2, :] = blended
    Image.fromarray(cur_out, "RGBA").save(cur_path)
    Image.fromarray(nb_out, "RGBA").save(nb_path)


def perform_inpainting(
    directory: str,
    inpaint_distance_px: int,
    leaf_node_ids: Iterable[QuadNodeId],
    num_threads: int = 8,
) -> None:
    if inpaint_distance_px == 0:
        return
    node_ids = list(leaf_node_ids)
    tiles = _TileSet(directory, node_ids)
    spatials = list(tiles.by_spatial)

    def run(fn, items):
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            list(pool.map(fn, items))

    # 1. enlarged + inpainted intermediate images.
    def create(spatial):
        big = _stitched(tiles, spatial)
        if big is not None:
            out = inpaint_image(big, inpaint_distance_px)
            Image.fromarray(out, "RGBA").save(tiles.inpaint_path(spatial))

    run(create, spatials)

    # 2./3. seam blending, checkerboarded so neighbors are never written
    # concurrently.
    for parity in (0, 1):
        run(
            lambda s: _interpolate_seam(tiles, s, Direction.RIGHT),
            [s for s in spatials if s.x % 2 == parity],
        )
    for parity in (0, 1):
        run(
            lambda s: _interpolate_seam(tiles, s, Direction.BOTTOM),
            [s for s in spatials if s.y % 2 == parity],
        )

    # 4. cut the original tile back out.
    def apply(spatial):
        path = tiles.inpaint_path(spatial)
        if not os.path.exists(path):
            return
        big = np.asarray(Image.open(path))
        h, w = big.shape[0] // 4, big.shape[1] // 4
        Image.fromarray(big[h : 3 * h, w : 3 * w], "RGBA").save(
            image_path(directory, tiles.by_spatial[spatial])
        )
        os.remove(path)

    run(apply, spatials)


def get_adjacent_leaf_node_ids(
    leaf_node_ids: Iterable[QuadNodeId],
    input_directory: str,
    root_node_id: QuadNodeId,
) -> set:
    """Leaf tiles of the four side-adjacent partial quadtrees that border
    this quadtree (reference: xray/src/bin/inpaint_xray_quadtree.rs:41-71).

    Partial quadtrees built with --root_node_id share one global quadtree
    coordinate system, so a neighbor quadtree's ``meta<id>.pb`` (expected
    to have been copied into input_directory alongside its border leaf
    tiles) lists node ids directly comparable with ours: keep each
    neighbor deepest-level tile whose opposite-direction neighbor is one
    of our leaves."""
    from .build import meta_pb_path
    from .meta import XrayMeta

    leaf_set = set(leaf_node_ids)
    adjacent = set()
    for direction in (
        Direction.LEFT,
        Direction.TOP,
        Direction.RIGHT,
        Direction.BOTTOM,
    ):
        neighbor_root = root_node_id.neighbor(direction)
        if neighbor_root is None:
            continue
        path = meta_pb_path(input_directory, neighbor_root)
        if not os.path.exists(path):
            continue
        neighbor_meta = XrayMeta.from_directory(
            input_directory, os.path.basename(path)
        )
        opposite = direction.opposite()
        for node_id in neighbor_meta.iter_level(neighbor_meta.deepest_level):
            toward_us = node_id.neighbor(opposite)
            if toward_us is not None and toward_us in leaf_set:
                adjacent.add(node_id)
    return adjacent
