"""The port's public surface against the JAX package's.

* Parity: every public top-level name and public class method of every
  module of point_cloud_viewer_tpu has its counterpart in the same module
  of point_cloud_viewer_tpu_torch, or in the CUDA wrapper a Pallas module
  maps to, or is one of the JAX-only names listed below with its reason.
* The package root's twelve names resolve with jax and the JAX package
  refused, and `__all__` is the JAX root's.
* PCV_DISABLE_NATIVE and `native.disabled()` turn both packages' native
  library off, and the host build then writes the JAX package's bytes.
* The device-API twins on the CPU: the padded entries and
  `sort_codes_device` bit-equal to JAX's, the culling building blocks
  within the tolerance stated below, and `torch_trace`.
"""

import ast
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from point_cloud_viewer_tpu.ops import culling as jax_culling
from point_cloud_viewer_tpu.ops import morton as jax_morton
from point_cloud_viewer_tpu.ops import tree_build as jax_tb
from point_cloud_viewer_tpu_torch.ops import culling as port_culling
from point_cloud_viewer_tpu_torch.ops import tree_build as tb

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX = os.path.join(_REPO, "point_cloud_viewer_tpu")
_PORT = os.path.join(_REPO, "point_cloud_viewer_tpu_torch")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- parity of names ---------------------------------------------------------

# Each Pallas module's counterpart: the CUDA wrapper module and, for each
# kernel entry, the wrapper's name.
_PALLAS_TO_CUDA = {
    "ops/scan_pallas.py": ("ops/scan_cuda.py", {"scan_1d": "scan_1d"}),
    "ops/level_pallas.py": ("ops/level_cuda.py", {
        "seg_start_pass": "seg_start_pass",
        "leaf_update_pass": "leaf_update_pass",
        "promote_pass": "promote_pass"}),
    "ops/culling_pallas.py": ("ops/cull_cuda.py", {
        "frustum_cull_lod_select_pallas": "cull_lod"}),
    "ops/tree_build_pallas.py": ("ops/leaf_levels_cuda.py", {
        "leaf_levels_pallas": "leaf_levels"}),
}

# Names the port gives another word for the other framework.
_RENAMED = {("utils/progress.py", "jax_trace"): "torch_trace"}

_TILING = ("Pallas tiling of the TPU's vector registers; the CUDA kernels "
           "choose their own tiles")

# (module, name) -> why the port has no counterpart.
_JAX_ONLY = {
    ("parallel/mesh.py", "shard_spec"):
        "returns a jax.sharding.NamedSharding; the port's mesh is a tuple "
        "of devices and shard/replicate place tensors directly",
    ("parallel/mesh.py", "replicated_spec"):
        "returns a jax.sharding.NamedSharding (as shard_spec)",
    ("ops/scan_pallas.py", "LANES"): _TILING,
    ("ops/scan_pallas.py", "ROWS"): _TILING,
    ("ops/scan_pallas.py", "out_struct"):
        "builds a jax.ShapeDtypeStruct for pl.pallas_call's out_shape",
    ("ops/level_pallas.py", "ROWS"): _TILING,
    ("ops/culling_pallas.py", "TILE"): _TILING,
    ("ops/culling_pallas.py", "A_PAD"): _TILING,
    ("ops/tree_build_pallas.py", "TILE"): _TILING,
    ("ops/tree_build_pallas.py", "L_PAD"): _TILING,
}


def _public_names(path, imports=False):
    """Public top-level names (functions, classes, assignments, the
    entries of a literal `__all__`, in `if`/`try` blocks too, and with
    `imports` the names imported from elsewhere: a re-export) and public
    methods of public classes, as "name" and "Class.method"."""
    with open(path, encoding="utf-8") as f:
        body = ast.parse(f.read()).body
    out = set()

    def visit(nodes):
        for node in nodes:
            if isinstance(node, (ast.If, ast.Try)):
                visit(node.body + node.orelse
                      + getattr(node, "finalbody", [])
                      + [x for h in getattr(node, "handlers", [])
                         for x in h.body])
                continue
            names = []
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names = [node.name]
            elif isinstance(node, ast.Assign):
                names = [t.id for t in node.targets if isinstance(t, ast.Name)]
                if names == ["__all__"]:
                    names = list(ast.literal_eval(node.value))
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                names = [node.target.id]
            elif imports and isinstance(node, ast.ImportFrom):
                names = [a.asname or a.name for a in node.names]
            out.update(n for n in names if not n.startswith("_"))
            if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and not m.name.startswith("_"))

    visit(body)
    return out


def _jax_modules():
    for root, _, files in os.walk(_JAX):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.relpath(os.path.join(root, name), _JAX)


def _missing(rel):
    """The JAX module's public names without a counterpart in the port."""
    jax_names = _public_names(os.path.join(_JAX, rel))
    port_rel, renamed = _PALLAS_TO_CUDA.get(rel, (rel, {}))
    port_path = os.path.join(_PORT, port_rel)
    port_names = (_public_names(port_path, imports=True)
                  if os.path.exists(port_path) else set())
    return sorted(
        n for n in jax_names
        if _RENAMED.get((rel, n), renamed.get(n, n)) not in port_names
        and (rel, n) not in _JAX_ONLY)


@pytest.mark.parametrize("rel", sorted(_jax_modules()))
def test_every_public_name_has_a_counterpart(rel):
    assert _missing(rel) == []


def test_the_jax_only_list_names_only_jax_names():
    """Each exemption names a public name the JAX module has and the port
    lacks, and the Pallas map's wrappers exist."""
    for rel, name in _JAX_ONLY:
        assert name in _public_names(os.path.join(_JAX, rel)), (rel, name)
        port_rel = _PALLAS_TO_CUDA.get(rel, (rel, {}))[0]
        port_path = os.path.join(_PORT, port_rel)
        assert not (os.path.exists(port_path)
                    and name in _public_names(port_path, True)), (rel, name)
    for rel, (port_rel, renamed) in _PALLAS_TO_CUDA.items():
        port_names = _public_names(os.path.join(_PORT, port_rel))
        assert set(renamed.values()) <= port_names, port_rel


# --- the package root --------------------------------------------------------


def test_root_all_is_the_jax_roots():
    import point_cloud_viewer_tpu as jax_pkg
    import point_cloud_viewer_tpu_torch as port_pkg

    assert port_pkg.__all__ == jax_pkg.__all__
    assert len(port_pkg.__all__) == 12
    for name in ("CURRENT_VERSION", "META_FILENAME", "NUM_POINTS_PER_BATCH",
                 "MAX_POINTS_PER_NODE"):
        assert getattr(port_pkg, name) == getattr(jax_pkg, name)
    with pytest.raises(AttributeError):
        port_pkg.no_such_name  # noqa: B018


_REFUSE = textwrap.dedent("""
    import sys

    def refused(name):
        return (name.split(".")[0] in ("jax", "jaxlib")
                or name == "point_cloud_viewer_tpu"
                or name.startswith("point_cloud_viewer_tpu."))

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if refused(name):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
""")


def _run(body, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra or {})
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSE + textwrap.dedent(body)], cwd=_REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_root_names_resolve_with_jax_refused():
    out = _run("""
        import importlib
        import point_cloud_viewer_tpu_torch as pcv
        print("torch on import", "torch" in sys.modules)
        for name in pcv.__all__:
            value = getattr(pcv, name)
            if not isinstance(value, (int, str)):
                module = importlib.import_module(value.__module__)
                assert getattr(module, name) is value, name
                assert value.__module__.startswith(
                    "point_cloud_viewer_tpu_torch."), value.__module__
        leaked = sorted(m for m in sys.modules if refused(m))
        assert not leaked, leaked
        print("resolved", len(pcv.__all__))
    """)
    assert "torch on import False" in out
    assert "resolved 12" in out


# --- the native switch -------------------------------------------------------


def test_disable_native_env_in_a_fresh_process():
    out = _run("""
        from point_cloud_viewer_tpu_torch import native
        print("available", native.available())
    """, {"PCV_DISABLE_NATIVE": "1"})
    assert "available False" in out


def _host_build(pkg, out_dir, batch):
    if pkg == "jax":
        from point_cloud_viewer_tpu.core.points_batch import PointsBatch
        from point_cloud_viewer_tpu.octree.builder import build_octree
    else:
        from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
        from point_cloud_viewer_tpu_torch.octree.builder import build_octree
    build_octree(str(out_dir), 0.01,
                 PointsBatch(position=batch["position"],
                             attributes={"color": batch["color"]}),
                 use_device=False)


@pytest.mark.parametrize("how", ["PCV_DISABLE_NATIVE", "disabled()"])
def test_native_switch_turns_both_off_and_builds_jax_bytes(how, tmp_path,
                                                           monkeypatch):
    import contextlib

    from point_cloud_viewer_tpu import native as jax_native
    from point_cloud_viewer_tpu_torch import native
    from tests.conftest import assert_dirs_byte_equal

    assert native.available() and jax_native.available()
    rng = np.random.default_rng(31)
    batch = {"position": rng.random((30_000, 3)) * 50.0,
             "color": rng.integers(0, 256, (30_000, 3), dtype=np.uint8)}
    with contextlib.ExitStack() as stack:
        if how == "PCV_DISABLE_NATIVE":
            stack.enter_context(monkeypatch.context()).setenv(
                "PCV_DISABLE_NATIVE", "yes")
        else:
            stack.enter_context(native.disabled())
            stack.enter_context(jax_native.disabled())
        assert native.lib() is None and not native.available()
        assert jax_native.lib() is None and not jax_native.available()
        _host_build("jax", tmp_path / "jax", batch)
        _host_build("port", tmp_path / "port", batch)
    assert native.available() and jax_native.available()
    assert_dirs_byte_equal(str(tmp_path / "jax"), str(tmp_path / "port"))


# --- the padded entries and the device sort ----------------------------------

_DEPTH = 8


def _halves(n, seed, root_level):
    """JAX's u32 code halves of n cells with hot duplicates, all inside
    one level-root_level cell."""
    if n == 0:
        z = np.zeros(0, dtype=np.uint32)
        return z, z
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 1 << (_DEPTH - root_level), (n, 3)).astype(
        np.uint32)
    cells[::5] = cells[0]
    return jax_morton.split_u64(jax_morton.morton_encode(cells))


def _equal(got, want):
    """Same values, each side's integer dtype widened."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


# Both sides of the ladder's first steps: 2^16 (the floor), 3 * 2^15.
_PADDED_N = [0, 1, 65_535, 65_536, 65_537, 98_304, 98_305]
_LADDER = {0: 0, 1: 65_536, 65_535: 65_536, 65_536: 65_536, 65_537: 98_304,
           98_304: 98_304, 98_305: 131_072}


@pytest.mark.parametrize("root", [0, 2])
@pytest.mark.parametrize("n", _PADDED_N)
def test_grouped_padded_entry_matches_jax(n, root):
    """Rows [0, n), the level counts with their pad bin and the extras
    bit-equal to JAX's; the pad rows too (they hold JAX's sentinel run)."""
    hi, lo = _halves(n, seed=n + root, root_level=root)
    want, n_want = jax_tb.tree_codes_grouped_on_device_padded(
        hi, lo, _DEPTH, _DEPTH, 100, root, root)
    got, n_got = tb.tree_codes_grouped_on_device_padded(
        hi, lo, _DEPTH, _DEPTH, 100, root, root, device="cpu")
    assert n_got == n_want == n
    assert got.order2.shape[0] == _LADDER[n]
    for name, g, w in zip(tb.GroupedExchange._fields, got, want):
        _equal(g, w)
    assert int(got.level_counts[-1]) == got.order2.shape[0] - n


@pytest.mark.parametrize("root", [0, 2])
@pytest.mark.parametrize("n", _PADDED_N)
def test_classic_padded_entry_matches_jax(n, root):
    hi, lo = _halves(n, seed=n + root + 7, root_level=root)
    idx, final, leaf, n_got = tb.tree_codes_on_device_padded(
        hi, lo, _DEPTH, _DEPTH, 100, root, root, device="cpu")
    assert n_got == n
    if n == 0:
        # The JAX entry raises on an empty input (an index into a
        # zero-length array); the port returns empty outputs.
        assert idx.shape == final.shape == leaf.shape == (0,)
        return
    w_idx, w_final, w_leaf, n_want = jax_tb.tree_codes_on_device_padded(
        hi, lo, _DEPTH, _DEPTH, 100, root, root)
    assert n_want == n
    for g, w in ((idx, w_idx), (final, w_final), (leaf, w_leaf)):
        _equal(g, w)


def test_grouped_padded_extras_overflow_matches_jax():
    """extras_cap=1 (tests/test_streaming_build.py:498-520): the sole
    occupants overflow the compact records, extras_total counts them
    all, and the classic arrays the caller falls back to equal JAX's."""
    rng = np.random.default_rng(12)
    cells = rng.integers(0, 1 << _DEPTH, (2_000, 3)).astype(np.uint32)
    hi, lo = jax_morton.split_u64(jax_morton.morton_encode(cells))
    want, n = jax_tb.tree_codes_grouped_on_device_padded(
        hi, lo, _DEPTH, _DEPTH, 4, 0, 0, extras_cap=1)
    got, n_got = tb.tree_codes_grouped_on_device_padded(
        hi, lo, _DEPTH, _DEPTH, 4, 0, 0, device="cpu", extras_cap=1)
    assert n_got == n == 2_000
    assert got.extras_idx.shape == (1,) and int(got.extras_total) > 1
    for g, w in zip(got, want):
        _equal(g, w)
    fetched = tb.fetch_grouped(got)
    assert fetched.overflow
    _equal(fetched.idx, np.asarray(want[5])[:fetched.idx.shape[0]])


def test_padded_entries_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hi, lo = _halves(100, seed=1, root_level=0)
    with pytest.raises(RuntimeError, match="is_available"):
        tb.tree_codes_grouped_on_device_padded(hi, lo, _DEPTH, _DEPTH)
    with pytest.raises(RuntimeError, match="is_available"):
        tb.tree_codes_on_device_padded(hi, lo, _DEPTH, _DEPTH)


@pytest.mark.parametrize("n", [0, 1, 65_535, 65_536, 65_537, 98_304, 98_305,
                               200_000])
def test_pad_codes_pow2_matches_jax(n):
    rng = np.random.default_rng(n)
    hi = rng.integers(0, 1 << 31, n, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    got, want = tb.pad_codes_pow2(hi, lo), jax_tb.pad_codes_pow2(hi, lo)
    assert got[2] == want[2] == n
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.uint32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape,floor", [((0,), 512), ((1,), 512),
                                         ((513, 3), 512), ((700, 2), 64),
                                         ((1024,), 512), ((5,), 1)])
def test_pad_rows_pow2_matches_jax(shape, floor):
    arr = np.random.default_rng(len(shape) * 1000 + shape[0]).random(shape)
    got, want = tb.pad_rows_pow2(arr, floor), jax_tb.pad_rows_pow2(arr, floor)
    assert got[1] == want[1] == shape[0]
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("n", [1, 5_000, 70_001])
def test_sort_codes_device_matches_jax(n):
    """On JAX's padded halves (its 0xFFFFFFFF sentinels sort last), as
    int64 tensors and as int32 bit patterns."""
    hi, lo = _halves(n, seed=n, root_level=0)
    hi, lo, _ = jax_tb.pad_codes_pow2(hi, lo)
    want = np.asarray(jax_tb.sort_codes_device(jnp.asarray(hi),
                                               jnp.asarray(lo)))
    for dtype in (np.int64, np.int32):
        got = tb.sort_codes_device(
            torch.from_numpy(hi.astype(np.int64).astype(dtype)
                             if dtype == np.int64 else hi.view(np.int32)),
            torch.from_numpy(lo.astype(np.int64).astype(dtype)
                             if dtype == np.int64 else lo.view(np.int32)))
        assert got.dtype == torch.int32
        _equal(got, want)
    codes = jax_morton.join_u64(hi[:n], lo[:n])
    _, order = tb.argsort_codes_on_device(codes, "cpu")
    np.testing.assert_array_equal(want[:n].astype(np.int64), order)


# --- the culling building blocks ---------------------------------------------

# The stated tolerance: relations equal but where a node's projection lies
# within TIE_ULP ulp of a query bound (such nodes are counted), sizes to
# SIZE_RTOL / SIZE_ATOL.  Worst case measured on these inputs (CPU, the
# port's f64-emulated fma chain against XLA:CPU's einsum): relations all
# equal, 0 near ties among them that differ, sizes bit-equal.
TIE_ULP = 4
SIZE_RTOL, SIZE_ATOL = 1e-5, 1e-7


def _cull_case(seed, k):
    from point_cloud_viewer_tpu_torch.ops.culling import (
        Frustum, Isometry, Perspective, frustum_axes_and_projections)

    rng = np.random.default_rng(seed)
    frustum = Frustum.new(
        Isometry.from_axis_angle([0.2, 1.0, 0.1], 0.3 + seed * 0.1,
                                 translation=[40.0, 40.0, 90.0]),
        Perspective.from_fov(1.2, 1.0, 0.5, 300.0))
    axes, qmin, qmax = frustum_axes_and_projections(frustum)
    mins = (rng.random((k, 3)) * 120.0 - 20.0).astype(np.float32)
    edges = (80.0 / np.exp2(rng.integers(0, 9, k))).astype(np.float32)
    matrix = np.asarray(frustum.clip_from_query, dtype=np.float32)
    return matrix, axes, qmin, qmax, mins, edges


def _near_tie(b_min, b_max, qmin, qmax):
    """(K,) bool: a corner projection bound within TIE_ULP ulp of a query
    bound on some axis."""
    def close(a, b):
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        return np.abs(a.astype(np.float64) - b) <= TIE_ULP * ulp

    return (close(b_min, qmax) | close(b_max, qmin) | close(b_min, qmin)
            | close(b_max, qmax)).any(axis=1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_culling_twins_match_jax(seed):
    matrix, axes, qmin, qmax, mins, edges = _cull_case(seed, 30_000)
    j_corners = jax_culling.node_corners(jnp.asarray(mins), jnp.asarray(edges))
    corners = port_culling.node_corners(torch.from_numpy(mins),
                                        torch.from_numpy(edges))
    np.testing.assert_array_equal(corners.numpy(), np.asarray(j_corners))

    want = np.asarray(jax_culling.sat_relation_device(
        jnp.asarray(axes), jnp.asarray(qmin), jnp.asarray(qmax), j_corners))
    got = port_culling.sat_relation_device(
        torch.from_numpy(axes), torch.from_numpy(qmin),
        torch.from_numpy(qmax), corners).numpy()
    assert got.dtype == want.dtype == np.int8
    assert set(np.unique(got)) == {port_culling.REL_IN,
                                   port_culling.REL_CROSS,
                                   port_culling.REL_OUT}
    proj = np.einsum("kcd,ad->kca", corners.numpy().astype(np.float64), axes)
    ties = _near_tie(proj.min(axis=1), proj.max(axis=1), qmin, qmax)
    differ = got != want
    assert not (differ & ~ties).any(), int((differ & ~ties).sum())
    assert int(differ.sum()) == 0, f"{int(differ.sum())} near-tie nodes differ"

    sizes = port_culling.relative_sizes_on_screen_device(
        torch.from_numpy(matrix), corners).numpy()
    j_sizes = np.asarray(jax_culling.relative_sizes_on_screen_device(
        jnp.asarray(matrix), j_corners))
    np.testing.assert_allclose(sizes, j_sizes, rtol=SIZE_RTOL, atol=SIZE_ATOL)
    assert sizes.dtype == j_sizes.dtype == np.float32


def test_culling_twins_stay_on_their_inputs_device():
    matrix, axes, qmin, qmax, mins, edges = _cull_case(4, 100)
    corners = port_culling.node_corners(torch.from_numpy(mins),
                                        torch.from_numpy(edges))
    assert corners.shape == (100, 8, 3) and corners.dtype == torch.float32
    rel = port_culling.sat_relation_device(
        torch.from_numpy(axes), torch.from_numpy(qmin),
        torch.from_numpy(qmax), corners)
    sizes = port_culling.relative_sizes_on_screen_device(
        torch.from_numpy(matrix), corners)
    assert rel.device == sizes.device == torch.device("cpu")
    assert rel.shape == sizes.shape == (100,)


# --- torch_trace ----------------------------------------------------------------


def test_torch_trace_without_log_dir_does_nothing(tmp_path, monkeypatch):
    from point_cloud_viewer_tpu_torch.utils import progress

    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with progress.torch_trace(log_dir):
            assert not torch.autograd.profiler._is_profiler_enabled
            torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_torch_trace_writes_a_chrome_trace_of_a_cpu_build(tmp_path):
    import json

    from point_cloud_viewer_tpu_torch import build_octree
    from point_cloud_viewer_tpu_torch.core.points_batch import PointsBatch
    from point_cloud_viewer_tpu_torch.utils.progress import torch_trace

    rng = np.random.default_rng(9)
    batch = PointsBatch(position=rng.random((20_000, 3)) * 10.0)
    log_dir = tmp_path / "new" / "traces"
    with torch_trace(str(log_dir)):
        result = build_octree(str(tmp_path / "octree"), 0.01, batch,
                              device="cpu")
    assert result.num_points == 20_000
    (name,) = os.listdir(log_dir)
    with open(log_dir / name) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert "aten::sort" in ops, sorted(ops)[:20]


def test_torch_trace_raises_when_it_cannot_write(tmp_path):
    from point_cloud_viewer_tpu_torch.utils.progress import torch_trace

    blocker = tmp_path / "a_file"
    blocker.write_bytes(b"")
    with pytest.raises(OSError):
        with torch_trace(str(blocker / "traces")):
            torch.ones(4).sum()
