"""DataProviderFactory: prefix-dispatched provider registry
(reference: src/data_provider/factory.rs:10-55).

Providers register a URL prefix (e.g. 'http://'); unmatched locations fall
back to the on-disk provider.  An HTTP provider is included so clouds can
be queried straight from any static file server.

Copy of point_cloud_viewer_tpu/io/factory.py:1-70, unchanged.
"""

from __future__ import annotations

import urllib.request
from typing import Callable, Dict, Iterable, List

from ..protos.meta import MetaProto
from .node_io import DataProvider, NodeNotFound, OnDiskDataProvider


class HttpDataProvider(DataProvider):
    """Reads meta.pb and node files over HTTP from a base URL."""

    def __init__(self, base_url: str) -> None:
        self.base_url = base_url.rstrip("/")

    def _fetch(self, name: str) -> bytes:
        from ..core.attributes import attribute_extension  # noqa: F401

        url = f"{self.base_url}/{name}"
        try:
            with urllib.request.urlopen(url, timeout=30) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise NodeNotFound(url)
            raise

    def meta_proto(self) -> MetaProto:
        return MetaProto.decode(self._fetch("meta.pb"))

    def meta_bytes(self) -> bytes:
        return self._fetch("meta.pb")

    def data(self, node_name: str, attributes: Iterable[str]) -> Dict[str, bytes]:
        from ..core.attributes import attribute_extension

        return {
            a: self._fetch(f"{node_name}.{attribute_extension(a)}")
            for a in attributes
        }


class DataProviderFactory:
    def __init__(self) -> None:
        self._makers: List = []  # (prefix, fn)

    def register(self, prefix: str, maker: Callable[[str], DataProvider]) -> "DataProviderFactory":
        self._makers.append((prefix, maker))
        return self

    def generate_data_provider(self, location: str) -> DataProvider:
        for prefix, maker in self._makers:
            if location.startswith(prefix):
                return maker(location)
        # Fallback: local directory (reference: factory.rs:44-53).
        return OnDiskDataProvider(location)


def default_factory() -> DataProviderFactory:
    f = DataProviderFactory()
    f.register("http://", HttpDataProvider)
    f.register("https://", HttpDataProvider)
    return f
