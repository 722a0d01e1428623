"""X-ray tile HTTP service (reference wire contract: xray/src/backend.rs):

* GET /meta                      -> {"bounding_rect": {"min_x", "min_y",
                                     "edge_length"}, "tile_size",
                                     "deepest_level"}
* GET /nodes_for_level?level=L&matrix=m0,..,m15 (column-major)
                                 -> [{"id", "bounding_rect": {...}}, ...]
* GET /node_image/<id>           -> PNG bytes
* GET /                          -> built-in 2D map viewer (ours)

Copy of point_cloud_viewer_tpu/xray/backend.py:1-123, unchanged.
"""

from __future__ import annotations

import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .meta import XrayMeta

_CLIENT_HTML = os.path.join(os.path.dirname(__file__), "client.html")


class OnDiskXray:
    def __init__(self, directory: str) -> None:
        self.directory = directory
        self.meta = XrayMeta.from_directory(directory)

    def get_node_image(self, node_id: str) -> bytes:
        if "/" in node_id or not node_id.startswith("r"):
            raise FileNotFoundError(node_id)
        with open(os.path.join(self.directory, node_id + ".png"), "rb") as f:
            return f.read()


class _Handler(BaseHTTPRequestHandler):
    xray: OnDiskXray
    prefix: str = ""

    def log_message(self, fmt, *args):
        pass

    def _send(self, code, content_type, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        path = url.path
        if self.prefix and path == self.prefix:
            # The client uses relative URLs; they only resolve under the
            # prefix when the page URL ends with '/'.
            self.send_response(301)
            self.send_header("Location", self.prefix + "/")
            self.end_headers()
            return
        if self.prefix and path.startswith(self.prefix):
            path = path[len(self.prefix):] or "/"
        try:
            if path in ("/", "/index.html"):
                with open(_CLIENT_HTML, "rb") as f:
                    self._send(200, "text/html", f.read())
            elif path == "/meta":
                m = self.xray.meta
                body = json.dumps(
                    {
                        "bounding_rect": {
                            "min_x": m.bounding_rect.min_x,
                            "min_y": m.bounding_rect.min_y,
                            "edge_length": m.bounding_rect.edge_length,
                        },
                        "tile_size": m.tile_size,
                        "deepest_level": m.deepest_level,
                    }
                ).encode()
                self._send(200, "application/json", body)
            elif path == "/nodes_for_level":
                q = parse_qs(url.query)
                level = int(q["level"][0])
                entries = [float(v) for v in q["matrix"][0].split(",")]
                tiles = self.xray.meta.get_nodes_for_level(level, entries)
                body = json.dumps(
                    [
                        {
                            "id": t.id,
                            "bounding_rect": {
                                "min_x": t.min_x,
                                "min_y": t.min_y,
                                "edge_length": t.edge_length,
                            },
                        }
                        for t in tiles
                    ]
                ).encode()
                self._send(200, "application/json", body)
            elif path.startswith("/node_image/"):
                node_id = path[len("/node_image/"):]
                self._send(200, "image/png", self.xray.get_node_image(node_id))
            else:
                self._send(404, "text/plain", b"not found")
        except (FileNotFoundError, KeyError):
            self._send(404, "text/plain", b"not found")
        except ValueError as e:
            self._send(400, "text/plain", str(e).encode())
        except Exception as e:  # noqa: BLE001
            self._send(500, "text/plain", f"{type(e).__name__}: {e}".encode())


def make_server(directory: str, ip: str = "127.0.0.1", port: int = 5434, prefix: str = ""):
    handler = type(
        "BoundHandler", (_Handler,), {"xray": OnDiskXray(directory), "prefix": prefix}
    )
    return ThreadingHTTPServer((ip, port), handler)


def serve_forever(directory: str, ip: str = "127.0.0.1", port: int = 5434) -> None:
    server = make_server(directory, ip, port)
    print(f"Serving xray tiles from {directory!r} on http://{ip}:{port}/")
    server.serve_forever()
