"""Extension (plugin) hook for CLIs and viewers.

The reference lets downstream users inject extra flags and a global
transform into its binaries via an Extension trait
(sdl_viewer/src/lib.rs:296-302, xray/src/build_quadtree.rs:16-19).  Here an
extension is any importable object with optional hooks:

    class MyExtension:
        def add_arguments(self, parser): ...
        def query_from_global(self, args) -> Isometry | None: ...
        def after_build(self, args, result): ...

loaded by dotted path `package.module:attr` via --extension.

Copy of point_cloud_viewer_tpu/utils/extension.py:1-40, unchanged.
"""

from __future__ import annotations

import importlib
from typing import Optional


def load_extension(spec: Optional[str]):
    """'pkg.mod:attr' -> the attr (instantiated if it's a class)."""
    if not spec:
        return None
    module_name, _, attr = spec.partition(":")
    module = importlib.import_module(module_name)
    obj = getattr(module, attr) if attr else getattr(module, "Extension")
    if isinstance(obj, type):
        obj = obj()
    return obj


def apply_hook(extension, hook: str, *args, default=None):
    if extension is None:
        return default
    fn = getattr(extension, hook, None)
    if fn is None:
        return default
    return fn(*args)
