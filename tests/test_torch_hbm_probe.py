"""K7, the port's streaming-bandwidth probe (point_cloud_viewer_tpu_torch/
ops/hbm_probe.py), on the CPU: its plain version against the JAX probe
expressions of bench.py:152 (`v + acc`), :239 (`x + acc * y`) and :249
(`x + y + acc * z`), and against the `pallas_copy` body (bench.py:196-211,
rebuilt here) run through `pl.pallas_call(..., interpret=True)`; bit for
bit, with f32 scalars and ragged n.

The jnp expressions run eagerly, one primitive at a time, as separately
rounded IEEE ops.  Under jit, XLA on the CPU contracts `x + acc * y` into a
fused multiply-add (one rounding), which the kernel avoids on purpose
(__fmul_rn / __fadd_rn in csrc/stream_probe.cu), so the jitted form is not
the yardstick here.  The CUDA kernel itself is held to the plain version on
the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from point_cloud_viewer_tpu_torch.ops import hbm_probe as K7

SIZES = [1, 3, 5, 4097, 1_000_003]


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x, y, z = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    return x, y, z, np.float32(rng.standard_normal())


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("mode", ["copy", "triad", "add3"])
def test_plain_probe_matches_jnp_bit_for_bit(mode, n):
    x, y, z, s = _inputs(n, seed=n)
    for acc in (s, np.float32(0.0), np.float32(1e-30)):
        jx, jy, jz, ja = (jnp.asarray(v) for v in (x, y, z, acc))
        want = {"copy": lambda: jx + ja,
                "triad": lambda: jx + ja * jy,
                "add3": lambda: jx + jy + ja * jz}[mode]()
        extra = {"copy": (), "triad": (y,), "add3": (y, z)}[mode]
        got = K7.stream_probe(mode, torch.from_numpy(x),
                              torch.tensor([acc]),
                              *(torch.from_numpy(e) for e in extra))
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("grid,tail", [(1, 0), (2, 1000)])
def test_copy_matches_pallas_copy_in_interpret_mode(grid, tail):
    """bench.py:191-211 with its (2048, 128) blocks: the Pallas grid covers
    whole blocks only, n_eff = n // 262144 * 262144; the probe runs K7 over
    those n_eff elements."""
    lanes, rows = 128, 2048
    m = grid * rows
    n_eff = m * lanes

    def copy_kernel(s_ref, x_ref, o_ref):
        o_ref[:] = x_ref[:] + s_ref[0, 0]

    copy = pl.pallas_call(
        copy_kernel,
        out_shape=jax.ShapeDtypeStruct((m, lanes), jnp.float32),
        grid=(grid,),
        in_specs=[
            pl.BlockSpec((1, 1), lambda i: (0, 0), memory_space=pltpu.SMEM),
            pl.BlockSpec((rows, lanes), lambda i: (i, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((rows, lanes), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )
    x, _, _, s = _inputs(n_eff + tail, seed=grid)
    want = np.asarray(copy(jnp.asarray(s).reshape(1, 1),
                           jnp.asarray(x[:n_eff]).reshape(m, lanes)))
    assert n_eff == (n_eff + tail) // (lanes * rows) * lanes * rows
    got = K7.stream_probe("copy", torch.from_numpy(x[:n_eff]),
                          torch.tensor([s]))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want).ravel())


def test_stream_probe_checks_its_inputs_and_launches_nothing_on_cpu():
    x = torch.zeros(8)
    s = torch.zeros(1)
    before = K7.stream_probe.launches
    with pytest.raises(ValueError, match="unknown probe mode"):
        K7.stream_probe("scale", x, s)
    with pytest.raises(ValueError, match="takes x, s, y"):
        K7.stream_probe("triad", x, s)
    with pytest.raises(ValueError, match="takes x, s$"):
        K7.stream_probe("copy", x, s, x)
    with pytest.raises(ValueError, match="takes x, s, y, z"):
        K7.stream_probe("add3", x, s, None, x)
    with pytest.raises(ValueError, match="shape"):
        K7.stream_probe("triad", x, s, torch.zeros(9))
    with pytest.raises(ValueError, match="float32"):
        K7.stream_probe("copy", x.double(), s)
    with pytest.raises(ValueError, match="one-element"):
        K7.stream_probe("copy", x, torch.zeros(2))
    assert K7.stream_probe("copy", x[:0], s).shape == (0,)
    assert torch.equal(K7.stream_probe("add3", x + 1, s + 2, x + 3, x + 4),
                       torch.full((8,), 12.0))
    assert K7.stream_probe.launches == before


def test_hbm_probes_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        K7.hbm_probes("cuda", n=1024, iters=1)
    with pytest.raises(ValueError, match="measures a card"):
        K7.hbm_probes("cpu", n=1024, iters=1)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H200", 4800.0),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_published_peak_by_card_name(name, peak):
    assert K7.published_peak_gbps(name) == peak
