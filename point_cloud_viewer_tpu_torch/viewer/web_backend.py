"""Octree web service.

Speaks the reference's exact HTTP + binary wire contract
(octree_web_viewer/src/backend.rs, utils.rs:40-56) so its web client works
against this server unchanged:

* GET  /init_tree                      -> plain-text initial octree id
* GET  /visible_nodes/{id}/?matrix=m0,..,m15  (column-major f64)
                                       -> JSON array of node names
* POST /nodes_data/{id}/  body: JSON [names]
                                       -> binary blob; per node:
     f64 min.x | f64 min.y | f64 min.z | f64 edge_length |
     u32 num_points | u8 bytes_per_coordinate | pad to 8 |
     positions | pad to 8 | rgb | pad to 8     (all little-endian)
* GET  /                               -> built-in viewer page (ours)

Implemented on the stdlib ThreadingHTTPServer — no third-party web
framework.  Octrees are cached per id; the id maps to
`prefix/<id>/suffix` like the reference's AppState (state.rs:28-98).

Copy of point_cloud_viewer_tpu/viewer/web_backend.py:1-212, unchanged.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..octree.node_id import NodeId
from ..octree.octree import Octree

_CLIENT_HTML = os.path.join(os.path.dirname(__file__), "client.html")


class AppState:
    def __init__(
        self,
        prefix: str,
        suffix: str = "",
        init_octree_id: str = "",
        cache_items: int = 20,
    ) -> None:
        from collections import OrderedDict

        self.prefix = prefix
        self.suffix = suffix
        self.init_octree_id = init_octree_id
        self.cache_items = cache_items
        self._cache: "OrderedDict[str, Octree]" = OrderedDict()
        self._lock = threading.Lock()
        self._loading: dict = {}  # id -> Event: single-flight loads

    def octree_address(self, octree_id: str) -> str:
        return os.path.join(self.prefix, octree_id, self.suffix).rstrip("/")

    def load_octree(self, octree_id: str) -> Octree:
        # Single-flight: concurrent requests for the same uncached id (the
        # client fires /visible_nodes and /nodes_data together on startup)
        # must not each run the full multi-second Octree load.
        while True:
            with self._lock:
                if octree_id in self._cache:
                    self._cache.move_to_end(octree_id)
                    return self._cache[octree_id]
                ev = self._loading.get(octree_id)
                if ev is None:
                    ev = threading.Event()
                    self._loading[octree_id] = ev
                    break  # we are the loader
            ev.wait()  # another handler is loading it; retry once done
        try:
            octree = Octree.from_directory(self.octree_address(octree_id))
            with self._lock:
                self._cache[octree_id] = octree
                self._cache.move_to_end(octree_id)
                while len(self._cache) > self.cache_items:
                    self._cache.popitem(last=False)
            return octree
        finally:
            with self._lock:
                self._loading.pop(octree_id, None)
            ev.set()


def _pad8(blob: bytearray) -> None:
    rem = len(blob) % 8
    if rem:
        blob.extend(b"\0" * (8 - rem))


def build_nodes_data_blob(octree: Octree, node_names) -> bytes:
    """The binary reply (format above, reference backend.rs:110-162)."""
    blob = bytearray()
    for name in node_names:
        node_id = NodeId.from_str(name)
        meta, position, color = octree.get_node_data(node_id)
        bpc = meta.position_encoding.bytes_per_coordinate
        assert bpc * meta.num_points * 3 == len(position)
        assert meta.num_points * 3 == len(color)
        blob += struct.pack(
            "<dddd", meta.cube_min[0], meta.cube_min[1], meta.cube_min[2],
            meta.edge_length,
        )
        blob += struct.pack("<IB", meta.num_points, bpc)
        _pad8(blob)
        blob += position
        _pad8(blob)
        blob += color
        _pad8(blob)
    return bytes(blob)


class _Handler(BaseHTTPRequestHandler):
    state: AppState  # set by make_server
    verbose: bool = False

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, content_type: str, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._send(code, "text/plain", message.encode())

    def do_GET(self) -> None:
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if url.path == "/" or url.path == "/index.html":
                with open(_CLIENT_HTML, "rb") as f:
                    self._send(200, "text/html", f.read())
            elif url.path == "/init_tree":
                self._send(200, "text/plain", self.state.init_octree_id.encode())
            elif len(parts) == 2 and parts[0] == "visible_nodes":
                self._visible_nodes(parts[1], url)
            else:
                self._error(404, "not found")
        except FileNotFoundError:
            self._error(404, "octree not found")
        except Exception as e:  # noqa: BLE001 — surface to the client
            self._error(500, f"{type(e).__name__}: {e}")

    def do_POST(self) -> None:
        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        try:
            if len(parts) == 2 and parts[0] == "nodes_data":
                import time

                start = time.perf_counter()
                length = int(self.headers.get("Content-Length", "0"))
                names = json.loads(self.rfile.read(length))
                octree = self.state.load_octree(parts[1])
                blob = build_nodes_data_blob(octree, names)
                if self.verbose:
                    # Per-request stats (reference: backend.rs:164-168).
                    import sys

                    num_points = sum(
                        octree.node_meta(NodeId.from_str(n)).num_points
                        for n in names
                    )
                    ms = (time.perf_counter() - start) * 1e3
                    print(
                        f"Got {len(names)} nodes with {num_points} points "
                        f"({ms:.0f}ms).",
                        file=sys.stderr,
                    )
                self._send(200, "application/octet-stream", blob)
            else:
                self._error(404, "not found")
        except Exception as e:  # noqa: BLE001
            self._error(500, f"{type(e).__name__}: {e}")

    def _visible_nodes(self, octree_id: str, url) -> None:
        query = parse_qs(url.query)
        matrix_param = query.get("matrix", [""])[0]
        entries = [float(v) for v in matrix_param.split(",") if v]
        if len(entries) != 16:
            self._error(400, "Expected matrix with 16 elements")
            return
        # Entries are column-major.
        matrix = np.array(entries, dtype=np.float64).reshape(4, 4).T
        octree = self.state.load_octree(octree_id)
        # Vectorized id serialization: at 1B-cloud scale (~71k visible
        # nodes) the per-NodeId str()+json.dumps chain cost ~230 ms per
        # request; this is ~2 ms (measured, ROUND_NOTES r5).
        body = octree.visible_node_names_json(matrix)
        self._send(200, "application/json", body)


def make_server(state: AppState, ip: str = "127.0.0.1", port: int = 5433,
                verbose: bool = False):
    handler = type("BoundHandler", (_Handler,), {"state": state, "verbose": verbose})
    return ThreadingHTTPServer((ip, port), handler)


def serve_forever(state: AppState, ip: str = "127.0.0.1", port: int = 5433) -> None:
    server = make_server(state, ip, port)
    print(f"Serving octrees from {state.prefix!r} on http://{ip}:{port}/")
    server.serve_forever()
