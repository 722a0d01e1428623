"""K7: the streaming-bandwidth probe, and the card's measured memory rate.

Port of the repository's bench.py `_hbm_probes` (bench.py:124-270): its
Pallas kernel `pallas_copy` (the pl.pallas_call at bench.py:199) becomes the
hand-written CUDA kernel of csrc/stream_probe.cu, which also runs the
probe's triad and add3 shapes.  `stream_probe` launches it on a CUDA
tensor and runs its plain PyTorch version on a CPU tensor.

`hbm_probes` times every shape on the card and returns the JAX package's
key names; chip_smoke.py divides every kernel's bytes by the larger of
its `hbm_probe_gbps` (the max over the shapes) and the card's published
peak memory rate.  Each number stands
beside the card's name and power limit and its share of the card's
published peak memory rate.  A failing probe raises.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import torch

from . import _ext
from ..device import resolve_device

MODES = {"copy": 0, "triad": 1, "add3": 2}
# Whether each mode reads y and z beside x.
_STREAMS = {"copy": (False, False), "triad": (True, False),
            "add3": (True, True)}

# bench.py:191-194: the Pallas copy runs over whole (2048, 128) blocks.
_PALLAS_BLOCK = 128 * 2048
# Published peak memory rate, GB/s (NVIDIA data sheets, SXM parts), by a
# substring of torch.cuda.get_device_name.
PUBLISHED_PEAK_GBPS = {"H100 80GB HBM3": 3350.0, "H200": 4800.0}


def stream_probe_plain(mode: str, x: torch.Tensor, s: torch.Tensor,
                       y: Optional[torch.Tensor] = None,
                       z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version, one op at a time in the kernel's order:
    copy x + s, triad x + s*y, add3 (x + y) + s*z."""
    if mode == "copy":
        return x + s
    if mode == "triad":
        return x + s * y
    if mode == "add3":
        return (x + y) + s * z
    raise ValueError(f"unknown probe mode {mode!r}")


def stream_probe(mode: str, x: torch.Tensor, s: torch.Tensor,
                 y: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One streaming pass (see stream_probe_plain) over contiguous 1-D f32
    tensors of one length, with `s` a one-element f32 tensor on the same
    device.  CPU tensors: `stream_probe_plain`.  CUDA tensors: the K7
    kernel on PyTorch's current stream, counted in `stream_probe.launches`."""
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}")
    if (y is not None, z is not None) != _STREAMS[mode]:
        raise ValueError(f"stream_probe {mode}: takes x, s"
                         + ("" if mode == "copy" else
                            ", y" + (", z" if mode == "add3" else "")))
    extra = [t for t in (y, z) if t is not None]
    for name, t in zip("xyz", (x, *extra)):
        _ext.check_1d(f"stream_probe {name}", t, torch.float32)
        if t.shape != x.shape:
            raise ValueError(f"stream_probe: {name} has shape "
                             f"{tuple(t.shape)}, x {tuple(x.shape)}")
    if s.dtype != torch.float32 or s.numel() != 1:
        raise ValueError("stream_probe: s must be a one-element f32 tensor")
    if not _ext.on_cuda("stream_probe", x, s, *extra):
        return stream_probe_plain(mode, x, s, y, z)
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _ext.lib()
    with _ext.device_guard(x):
        err = lib.pcv_stream_probe(
            MODES[mode], x.data_ptr(),
            y.data_ptr() if y is not None else None,
            z.data_ptr() if z is not None else None,
            s.data_ptr(), out.data_ptr(), n, _ext.stream_ptr(x),
        )
    _ext.check(err, "stream_probe")
    stream_probe.launches += 1
    return out


stream_probe.launches = 0


def card_label(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    index = device.index if device.index is not None else 0
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def published_peak_gbps(name: str) -> Optional[float]:
    """The card's published peak memory rate in GB/s, or None for a card
    not in PUBLISHED_PEAK_GBPS."""
    for key, gbps in PUBLISHED_PEAK_GBPS.items():
        if key in name:
            return gbps
    return None


def _seconds_per_pass(step, s0: float, iters: int, device) -> float:
    """CUDA-event time of `iters` back-to-back passes, each fed the scalar
    out[-1] * 1e-30 of the pass before it (the carried `acc` of the JAX
    loop, bench.py:150-154), after one warm-up pass; seconds per pass."""
    s = torch.full((1,), s0, dtype=torch.float32, device=device)
    step(s)
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = step(s)
        s = out[-1:] * 1e-30
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def hbm_probes(device="cuda", n: int = 128_000_000, iters: int = 20,
               generator: Optional[torch.Generator] = None) -> dict:
    """Streaming-bandwidth probes on the card (bench.py:124-270), GB/s:

    * hbm_probe_add_1d_gbps -- `x + s` (torch.add), 2 x 4 B per element;
    * hbm_probe_add_2d_gbps -- the same through a (rows, 512) view;
    * hbm_probe_copy_gbps   -- K7 copy over the Pallas probe's whole
      (2048, 128) blocks, n_eff = n // 262144 * 262144 elements;
    * hbm_probe_triad_gbps  -- K7 triad `x + s*y`, 3 x 4 B;
    * hbm_probe_add3_gbps   -- K7 add3 `(x + y) + s*z`, 4 x 4 B;
    * hbm_probe_gbps        -- the max of the five.

    Beside them: `card` (name and power limit), `published_peak_gbps` and
    `hbm_probe_share_of_published_peak` (None for a card without a
    published figure here), and each shape's ms per pass.  Inputs are
    uniform [0, 1) f32 from `generator`.  Raises unless `device` is a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"hbm_probes measures a card: device {str(dev)!r} "
                         "is not cuda")
    x, y, z = (torch.rand(n, dtype=torch.float32, device=dev,
                          generator=generator) for _ in range(3))
    n2 = n - n % 512
    n_eff = n // _PALLAS_BLOCK * _PALLAS_BLOCK
    x2 = x[:n2].view(-1, 512)
    xe = x[:n_eff]
    shapes = {  # name: (one pass of s, initial s, bytes per pass)
        "add_1d": (lambda s: x + s, 0.0, 2 * 4 * n),
        "add_2d": (lambda s: (x2 + s).view(-1), 0.0, 2 * 4 * n2),
        "copy": (lambda s: stream_probe("copy", xe, s), 0.0, 2 * 4 * n_eff),
        "triad": (lambda s: stream_probe("triad", x, s, y), 1.0, 3 * 4 * n),
        "add3": (lambda s: stream_probe("add3", x, s, y, z), 1.0, 4 * 4 * n),
    }
    name = torch.cuda.get_device_name(dev)
    out = {"card": card_label(dev), "n": n, "n_eff": n_eff, "iters": iters}
    for shape, (step, s0, nbytes) in shapes.items():
        secs = _seconds_per_pass(step, s0, iters, dev)
        out[f"hbm_probe_{shape}_gbps"] = nbytes / secs / 1e9
        out[f"hbm_probe_{shape}_ms"] = secs * 1e3
    out["hbm_probe_gbps"] = max(out[f"hbm_probe_{k}_gbps"] for k in shapes)
    peak = published_peak_gbps(name)
    out["published_peak_gbps"] = peak
    out["hbm_probe_share_of_published_peak"] = (
        out["hbm_probe_gbps"] / peak if peak else None)
    return out
