"""X-ray quadtree build pipeline (reference: xray/src/generation.rs:410-780).

Leaf tiles query the point cloud per tile column (streamed through
PointCloudClient), splat through a coloring strategy, then the pyramid is
built bottom-up by mosaicking 4 children and Lanczos-downscaling.  Output:
`r<quaternary>.png` tiles + `meta.pb` (or `meta<id>.pb` for partial builds
rooted below 'r', mergeable with merge.py).

Port of point_cloud_viewer_tpu/xray/build.py:1-264.  The client is the
port's PointCloudClient, whose filter route its caller chooses; each tile's
strategy is made by the port's make_strategy, whose `device` (in
`strategy_kwargs`, "cuda" when absent) decides where the splat runs.  Up
to 8 tile threads share the default device and stream: no thread sets a
device or a stream, and no tensor outlives its tile (every reduction
returns numpy).  `build_xray_quadtree` takes an optional `stats` dict that
it fills with the leaf tiles written, the points splatted and the walls of
the leaf and pyramid passes."""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
from PIL import Image

from ..core.points_batch import PointsBatch
from ..math.geometry import Aabb, Isometry
from ..math.intervals import ClosedInterval
from ..protos.xray_meta import (
    CURRENT_XRAY_VERSION,
    RectProto,
    XrayMetaProto,
    XrayNodeIdProto,
)
from ..query.client import PointCloudClient
from ..query.point_query import PointQuery
from ..utils.progress import ProgressBar
from .generation import ColoringStrategy, make_strategy
from .quadtree import QuadNodeId, Rect, nodes_at_level

WHITE = (255, 255, 255, 255)


def image_path(directory: str, node_id: QuadNodeId) -> str:
    return os.path.join(directory, f"{node_id}.png")


def meta_pb_path(directory: str, root_id: QuadNodeId) -> str:
    name = str(root_id).replace("r", "meta", 1) + ".pb"
    return os.path.join(directory, name)


@dataclass
class XrayParameters:
    output_directory: str
    point_cloud_client: PointCloudClient
    query_from_global: Optional[Isometry] = None
    filter_intervals: Dict[str, ClosedInterval] = field(default_factory=dict)
    tile_background_color: Tuple[int, int, int, int] = WHITE
    tile_size_px: int = 256
    pixel_size_m: float = 0.01
    root_node_id: QuadNodeId = field(default_factory=QuadNodeId.root)


def find_quadtree_bounding_rect_and_levels(
    bbox: Aabb, tile_size_px: int, pixel_size_m: float
) -> Tuple[Rect, int]:
    """Smallest power-of-two multiple of the tile size covering the xy
    bounding box (reference: generation.rs:515-532)."""
    tile_size_m = tile_size_px * pixel_size_m
    levels = 0
    cur = tile_size_m
    diag = bbox.diag()
    while cur < diag[0] or cur < diag[1]:
        cur *= 2.0
        levels += 1
    return Rect(bbox.mins[0], bbox.mins[1], cur), levels


def xray_from_points(
    bbox: Aabb,
    image_size: int,
    strategy: ColoringStrategy,
    parameters: XrayParameters,
    splatted: Optional[List[int]] = None,
) -> Optional[np.ndarray]:
    """Render one tile; None if the tile column holds no points.  The
    points handed to the strategy are added to splatted[0] when given."""
    if parameters.query_from_global is not None:
        global_from_query = parameters.query_from_global.inverse()
        location = bbox.to_obb().transformed(global_from_query)
    else:
        location = bbox
    attributes = set(strategy.attributes) | set(parameters.filter_intervals)
    seen_any = [False]

    def callback(batch: PointsBatch) -> None:
        seen_any[0] = True
        if parameters.query_from_global is not None:
            batch = PointsBatch(
                position=parameters.query_from_global.transform_points(batch.position),
                attributes=batch.attributes,
            )
        strategy.process(batch, bbox, image_size)
        if splatted is not None:
            splatted[0] += len(batch)

    parameters.point_cloud_client.for_each_point_data(
        PointQuery(
            attributes=sorted(attributes),
            location=location,
            filter_intervals=parameters.filter_intervals,
        ),
        callback,
    )
    if not seen_any[0]:
        return None
    return strategy.render(image_size)


def get_bounding_box(bbox: Aabb, query_from_global: Optional[Isometry]) -> Aabb:
    if query_from_global is not None:
        return bbox.transform(query_from_global)
    return bbox


def build_xray_quadtree(
    strategy_kind: str,
    parameters: XrayParameters,
    strategy_kwargs: Optional[dict] = None,
    num_threads: Optional[int] = None,
    stats: Optional[dict] = None,
) -> XrayMetaProto:
    t0 = time.perf_counter()
    os.makedirs(parameters.output_directory, exist_ok=True)
    strategy_kwargs = strategy_kwargs or {}
    if num_threads is None:
        # The reference defaults to a fixed pool of 8
        # (xray/src/build.rs); on a 1-core host that just multiplies
        # GIL churn between numpy segment reductions, so size the pool
        # to the machine (tile I/O still overlaps compute at 2+).
        num_threads = max(2, min(8, os.cpu_count() or 1))

    bounding_box = get_bounding_box(
        parameters.point_cloud_client.bounding_box(), parameters.query_from_global
    )
    bounding_rect, deepest_level = find_quadtree_bounding_rect_and_levels(
        bounding_box, parameters.tile_size_px, parameters.pixel_size_m
    )
    root_id = parameters.root_node_id
    if root_id.level > deepest_level:
        raise ValueError("Specified root node id is outside quadtree.")
    root_rect = root_id.find_bounding_rect(bounding_rect)
    leaf_ids = nodes_at_level(root_id, deepest_level)

    created: Set[QuadNodeId] = set()
    points = [0]
    points_lock = threading.Lock()

    def build_leaf(node_id: QuadNodeId) -> None:
        rect = node_id.find_bounding_rect(bounding_rect)
        tile_bbox = Aabb(
            [rect.min_x, rect.min_y, bounding_box.mins[2]],
            [rect.max_x, rect.max_y, bounding_box.maxs[2]],
        )
        strategy = make_strategy(strategy_kind, **strategy_kwargs)
        splatted = [0]
        img = xray_from_points(
            tile_bbox, parameters.tile_size_px, strategy, parameters, splatted
        )
        with points_lock:
            points[0] += splatted[0]
        if img is not None:
            Image.fromarray(img, "RGBA").save(
                image_path(parameters.output_directory, node_id)
            )
            created.add(node_id)

    # Tiles are independent; the point decode is numpy (GIL-free) and the
    # splat is numpy or torch ops.
    bar = ProgressBar(len(leaf_ids), f"Building level {deepest_level}")

    def build_leaf_with_progress(node_id: QuadNodeId) -> None:
        build_leaf(node_id)
        bar.inc()

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(build_leaf_with_progress, leaf_ids))
    bar.finish()
    t_leaves = time.perf_counter()

    assign_background_color(
        parameters.output_directory, parameters.tile_background_color, created
    )
    all_nodes = create_non_leaf_nodes(
        created,
        deepest_level,
        root_id.level,
        parameters.output_directory,
        parameters.tile_background_color,
        parameters.tile_size_px,
    )
    meta = XrayMetaProto(
        version=CURRENT_XRAY_VERSION,
        bounding_rect=RectProto(
            min=(root_rect.min_x, root_rect.min_y), edge_length=root_rect.edge_length
        ),
        deepest_level=deepest_level,
        tile_size=parameters.tile_size_px,
        nodes=[
            XrayNodeIdProto(level=n.level, index=n.index)
            for n in sorted(all_nodes)
        ],
    )
    with open(meta_pb_path(parameters.output_directory, root_id), "wb") as f:
        f.write(meta.encode())
    if stats is not None:
        stats.update(leaf_tiles=len(created), tiles=len(all_nodes),
                     points=points[0], leaves_s=t_leaves - t0,
                     pyramid_s=time.perf_counter() - t_leaves)
    return meta


def assign_background_color(
    directory: str, background: Tuple[int, int, int, int], node_ids: Set[QuadNodeId]
) -> None:
    """Replace sub-threshold-alpha pixels with the background color
    (reference: generation.rs:684-708, threshold 128)."""
    for node_id in node_ids:
        path = image_path(directory, node_id)
        img = np.asarray(Image.open(path).convert("RGBA")).copy()
        mask = img[:, :, 3] < 128
        img[mask] = background
        Image.fromarray(img, "RGBA").save(path)


def build_parent(
    children: List[Optional[np.ndarray]], background: Tuple[int, int, int, int]
) -> np.ndarray:
    """Mosaic 4 child tiles into a 2Nx2N image.  Child placement inverts y
    (image origin top-left): child 1 top-left, 0 bottom-left, 3 top-right,
    2 bottom-right (reference: generation.rs:410-451)."""
    size = next(c.shape[0] for c in children if c is not None)
    big = np.empty((2 * size, 2 * size, 4), dtype=np.uint8)
    big[:] = background
    for cid, (yo, xo) in [(1, (0, 0)), (0, (size, 0)), (3, (0, size)), (2, (size, size))]:
        if children[cid] is not None:
            big[yo : yo + size, xo : xo + size] = children[cid]
    return big


def create_non_leaf_nodes(
    created_leaf_ids: Set[QuadNodeId],
    deepest_level: int,
    root_level: int,
    directory: str,
    background: Tuple[int, int, int, int],
    tile_size_px: int,
) -> Set[QuadNodeId]:
    all_nodes: Set[QuadNodeId] = set(created_leaf_ids)
    current = created_leaf_ids
    for level in range(deepest_level - 1, root_level - 1, -1):
        current = {n.parent() for n in current}
        for node_id in current:
            build_node(directory, node_id, tile_size_px, background)
        all_nodes |= current
    return all_nodes


def build_node(
    directory: str,
    node_id: QuadNodeId,
    tile_size_px: int,
    background: Tuple[int, int, int, int],
) -> None:
    children: List[Optional[np.ndarray]] = [None] * 4
    for i in range(4):
        path = image_path(directory, node_id.child(i))
        if os.path.exists(path):
            children[i] = np.asarray(Image.open(path).convert("RGBA"))
    if not any(c is not None for c in children):
        return
    big = build_parent(children, background)
    img = Image.fromarray(big, "RGBA").resize(
        (tile_size_px, tile_size_px), Image.LANCZOS
    )
    img.save(image_path(directory, node_id))
