"""Device meshes for sharded builds (port of point_cloud_viewer_tpu/
parallel/mesh.py).

The JAX build is single-controller: one process holds the batch, puts one
shard on each device of a 1-D `jax.sharding.Mesh` and gathers the results.
Its PyTorch form is a mesh that is a tuple of `torch.device`s, one per
shard, driven from one thread; a shard's work is queued on its device's
current stream, so shards on different cards run at once.  A device may
appear more than once: shards that share a card run one after another on
it, the counterpart of the JAX tests' virtual CPU devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

Mesh = Tuple[torch.device, ...]

# The JAX mesh's axis name (mesh.py:11).  The port's mesh is a tuple and
# names no axis; the constant stays for callers that name one.
SHARD_AXIS = "shard"


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device="cuda",
) -> Mesh:
    """1-D mesh over the first n devices (mesh.py:14-24).

    `devices`: the shards' devices as given (each resolved; one may repeat).
    Otherwise `device`'s type picks them: "cuda" takes the visible cards,
    truncated to n as `jax.devices()[:n]` is, and raises without a card;
    "cpu" takes n CPU shards (default 1), cpu:0 .. cpu:n-1."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            # cpu:0, cpu:1, ...: one CPU, with shards told apart as the
            # JAX tests' virtual CPU devices are.
            devices = [torch.device("cpu", i)
                       for i in range(1 if n_devices is None else n_devices)]
    devices = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return tuple(devices)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def shard(x: Union[np.ndarray, torch.Tensor], mesh: Mesh) -> list:
    """Equal leading slices of x, slice s on mesh[s] (shard_spec,
    mesh.py:27-29); the leading dimension must divide by the mesh size."""
    t = _as_tensor(x)
    if t.shape[0] % len(mesh):
        raise ValueError(f"leading dimension {t.shape[0]} does not divide "
                         f"over {len(mesh)} shards")
    per = t.shape[0] // len(mesh)
    return [t[s * per:(s + 1) * per].to(d) for s, d in enumerate(mesh)]


def replicate(x: Union[np.ndarray, torch.Tensor], mesh: Mesh) -> list:
    """One copy of x on each mesh device (replicated_spec, mesh.py:32-33);
    shards on one device share its copy."""
    t = _as_tensor(x)
    copies = {}
    for d in mesh:
        if d not in copies:
            copies[d] = t.to(d)
    return [copies[d] for d in mesh]
