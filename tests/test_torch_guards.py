"""Boundaries of the PyTorch port: it imports no JAX, Orbax or JAX package,
its entry points run on the card unless asked for the CPU and raise with
no card, the kernel build names nvcc when it is missing, the kernel
wrappers reject what their
kernels do not take, unported routes raise NotImplementedError instead of
running something else, and the routes ported since (the Chebyshev
smoother, schedules beyond the fused legs' caps, the unfused ops of a
packed level, the sparse matrices of as_csr/as_coo, full multigrid on one
device and sharded) run and agree with the plain route or the JAX
package."""
import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import multigridcmt_tpu_torch as mt
from multigridcmt_tpu_torch import api, convert, grids, kernels
from multigridcmt_tpu_torch.config import SolverConfig
from multigridcmt_tpu_torch.kernels import (_build, bell, fused2d, packed2d,
                                            spmv, stencil2d, stencil3d,
                                            transfer2d)
from multigridcmt_tpu_torch.ops import smoothers, sparse, transfer

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multigridcmt_tpu_torch"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _is_jax_side(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "orbax", "multigridcmt_tpu")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path) if _is_jax_side(m)]
    assert not bad, f"{path} imports {bad}"


def test_kernel_wrappers_have_no_fallback_handlers():
    """On a CUDA tensor a wrapper launches its kernel or raises: nothing in
    the kernel package catches an exception to run another route."""
    for path in sorted((PORT / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text())
        handlers = [n for n in ast.walk(tree)
                    if isinstance(n, ast.ExceptHandler)]
        assert not handlers, f"{path} has an except clause"


def test_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mt.poisson2d(k=4, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.check_device("cuda:0")


def test_entry_points_default_to_the_card(monkeypatch):
    """With no device argument every entry point that builds tensors
    targets CUDA, so with no card it raises instead of running on the CPU;
    device="cpu" runs there."""
    import multigridcmt_tpu as jmg
    from multigridcmt_tpu.kernels import bell as jbell
    from multigridcmt_tpu.kernels import spmv as jspmv
    from multigridcmt_tpu.ops import sparse as jsparse

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert grids.DEFAULT_DEVICE == "cuda"
    cfg = SolverConfig(ndim=2, k=3)
    jprob = jmg.poisson2d(k=3)
    jdia = jsparse.laplacian_dia(7, 2, 0.125)
    a_sp = sparse.csr_to_scipy(sparse.laplacian_csr(7, 2, 0.125,
                                                    device="cpu"))
    jbl = jbell.bell_from_scipy(a_sp)
    for call in (lambda: mt.poisson2d(k=3),
                 lambda: mt.poisson3d(k=2),
                 lambda: grids.build_hierarchy(cfg),
                 lambda: grids.grid_coords(7, 2, torch.float64),
                 lambda: convert.hierarchy_from_jax(jprob.hierarchy),
                 lambda: convert.problem_from_jax(jprob),
                 lambda: sparse.laplacian_coo(7, 2, 0.125),
                 lambda: sparse.laplacian_csr(7, 1, 0.125),
                 lambda: sparse.laplacian_dia(7, 3, 0.125),
                 lambda: sparse.scipy_to_csr(a_sp),
                 lambda: sparse.prolongation_csr(3, 2),
                 lambda: sparse.restriction_csr(3, 1),
                 lambda: bell.bell_from_scipy(a_sp),
                 lambda: convert.csr_from_jax(jsparse.laplacian_csr(7, 2,
                                                                    0.125)),
                 lambda: convert.coo_from_jax(jsparse.laplacian_coo(7, 2,
                                                                    0.125)),
                 lambda: convert.dia_from_jax(jdia),
                 lambda: convert.packed_dia_from_jax(jspmv.pack_dia(jdia)),
                 lambda: convert.bell_from_jax(jbl)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    prob = mt.poisson2d(k=3, device="cpu")
    assert prob.b.device.type == "cpu"
    assert prob.hierarchy.coarse_inv.device.type == "cpu"
    assert convert.problem_from_jax(jprob, device="cpu").b.device.type \
        == "cpu"
    # Built on the CPU on request; as_csr/as_coo follow the problem's
    # device, and the transforms keep their input's.
    solver = mt.MultigridSolver(prob)
    assert solver.as_csr().data.device.type == "cpu"
    assert solver.as_coo().row.device.type == "cpu"
    # FMG and the eigensolvers run where the problem lives.
    assert solver.fmg().device.type == "cpu"
    for method in ("ii", "lobpcg"):
        pairs = solver.eigensolve(k=1, method=method)
        assert pairs.eigenvectors.device.type == "cpu"
    dia = sparse.laplacian_dia(7, 2, 0.125, device="cpu")
    assert spmv.pack_dia(dia).offset_tensor.device.type == "cpu"
    assert sparse.coo_to_csr(solver.as_coo()).indptr.device.type == "cpu"
    assert bell.bell_from_scipy(a_sp, device="cpu").cols.device.type == "cpu"


def test_build_names_nvcc_when_missing(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library(tmp_path / "out")
    assert not (tmp_path / "out" / _build.LIB_NAME).exists()


def test_build_keys_output_by_source_hash():
    h = _build.source_hash()
    assert len(h) == 16 and h == _build.source_hash()
    names = {p.name for p in _build.sources()}
    assert {"common.cuh", "fused2d.cu", "packed2d.cu", "stencil2d.cu",
            "stencil3d.cu", "transfer2d.cu", "spmv.cu", "bell.cu"} <= names
    # Every C entry point the wrappers call is declared for ctypes.
    for kernel in ("stencil2d_residual", "stencil2d_sweep", "fused2d_down",
                   "fused2d_up", "transfer2d_residual_restrict",
                   "transfer2d_prolong_add", "packed2d_down", "packed2d_up",
                   "packed2d_resnorm", "packed2d_residual", "packed2d_rbgs",
                   "stencil3d_residual", "stencil3d_jacobi",
                   "stencil3d_rbgs", "spmv_dia", "bell_spmm"):
        for t in ("f32", "f64"):
            assert f"mg_{kernel}_{t}" in _build.SIGNATURES
    # ... and each bfloat16 storage mode, with its float32 twin's
    # arguments.
    for kernel in ("packed2d_down", "packed2d_up", "packed2d_residual",
                   "packed2d_rbgs", "packed2d_resnorm", "stencil3d_residual",
                   "stencil3d_jacobi", "stencil3d_rbgs", "local2d_down",
                   "local2d_up", "plocal2d_down", "plocal2d_up",
                   "plocal2d_residual", "plocal2d_resnorm", "bell_spmm"):
        assert (_build.SIGNATURES[f"mg_{kernel}_bf16"]
                == _build.SIGNATURES[f"mg_{kernel}_f32"])
    # ... and the native bfloat16 modes (the 2D stencils' own entry points;
    # the SpMV with its float32 twin's arguments).
    assert "native_bf16.cu" in names
    assert {"mg_native2d_residual_bf16",
            "mg_native2d_sweep_bf16"} <= set(_build.SIGNATURES)
    assert {"fused2d_native_bf16.cu", "fused2d_up_native_bf16.cu"} <= names
    assert {"mg_fused2d_down_native_bf16",
            "mg_fused2d_up_native_bf16"} <= set(_build.SIGNATURES)
    assert {"stencil2d_sweep_native_bf16.cu",
            "stencil2d_jacobi_native_bf16.cu", "transfer2d_native_bf16.cu",
            "transfer2d_prolong_native_bf16.cu"} <= names
    assert {"mg_stencil2d_sweep_native_bf16",
            "mg_stencil2d_jacobi_native_bf16",
            "mg_native2d_residual_restrict_bf16",
            "mg_transfer2d_prolong_add_native_bf16"} <= set(
        _build.SIGNATURES)
    assert (_build.SIGNATURES["mg_spmv_dia_bf16"]
            == _build.SIGNATURES["mg_spmv_dia_f32"])


def _grid(n, dtype=torch.float64):
    return torch.zeros((n + 2, n + 2), dtype=dtype)


def _packed(n, dtype=torch.float64):
    return torch.zeros(packed2d.packed_shape(n), dtype=dtype)


def _cube(n, dtype=torch.float64):
    return torch.zeros((n + 2,) * 3, dtype=dtype)


def _pdia(dtype=torch.float64):
    """The packed 1D operator at n=100 (R = 8 rows, halo 8)."""
    return spmv.pack_dia(sparse.laplacian_dia(100, 1, 0.01, dtype,
                                              device="cpu"))


def _px(dtype=torch.float64):
    return torch.zeros((24, 128), dtype=dtype)


def _bell(dtype=torch.float64):
    return bell.BELL(data=torch.zeros((2, 1, 128, 128), dtype=dtype),
                     cols=torch.zeros((2, 1), dtype=torch.int32),
                     shape=(256, 256), nnz_scalar=0)


@pytest.mark.parametrize("bad,err", [
    (lambda: stencil2d.residual(_grid(7, torch.float16),
                                _grid(7, torch.float16), 7, 0.125),
     TypeError),
    (lambda: stencil2d.residual(_grid(7), _grid(7, torch.float32), 7, 0.125),
     ValueError),
    (lambda: stencil2d.residual(_grid(7), _grid(9), 7, 0.125), ValueError),
    (lambda: stencil2d.residual(_grid(7).t(), _grid(7), 7, 0.125),
     ValueError),
    (lambda: fused2d.smooth_residual_restrict(
        _grid(7), _grid(7), 7, 0.125, kind="rbgs", omega=1.0, sweeps=4),
     ValueError),
    (lambda: fused2d.smooth_residual_restrict(
        _grid(7), _grid(7), 7, 0.125, kind="chebyshev", omega=1.0, sweeps=1),
     ValueError),
    (lambda: fused2d.smooth_residual_restrict(
        _grid(8), _grid(8), 8, 0.125, kind="rbgs", omega=1.0, sweeps=1),
     ValueError),
    (lambda: fused2d.prolong_add_smooth(
        _grid(7), _grid(4), _grid(7), 7, 3, 0.125, kind="jacobi", omega=0.8,
        sweeps=1), ValueError),
    (lambda: fused2d.prolong_add_smooth(
        _grid(7), _grid(3), _grid(7), 7, 3, 0.125, kind="jacobi", omega=0.8,
        sweeps=9), ValueError),
    (lambda: stencil2d.residual(torch.zeros((9, 9), device="meta"),
                                torch.zeros((9, 9), device="meta"), 7, 0.125),
     ValueError),
    (lambda: packed2d.smooth_residual_restrict(
        _grid(7), _grid(7), 7, 0.125, kind="rbgs", omega=1.0, sweeps=1),
     ValueError),
    (lambda: packed2d.smooth_residual_restrict(
        _packed(7), _packed(7), 7, 0.125, kind="rbgs", omega=1.0, sweeps=4),
     ValueError),
    (lambda: packed2d.prolong_add_smooth(
        _packed(7), _packed(4), _packed(7), 7, 3, 0.125, kind="rbgs",
        omega=1.0, sweeps=1), ValueError),
    (lambda: packed2d.prolong_add_smooth(
        _packed(7), _grid(3), _packed(7), 7, 3, 0.125, kind="jacobi",
        omega=0.8, sweeps=9), ValueError),
    (lambda: packed2d.residual_norm_sq(
        _packed(7, torch.float16), _packed(7, torch.float16), 7, 0.125),
     TypeError),
    (lambda: packed2d.residual_norm_sq(_packed(7), _packed(9), 7, 0.125),
     ValueError),
    (lambda: packed2d.residual(_grid(7), _grid(7), 7, 0.125), ValueError),
    # bfloat16 storage is the packed residual's mixed mode, with b of the
    # same dtype (a float32 b is refused).
    (lambda: packed2d.residual(_packed(7, torch.bfloat16),
                               _packed(7, torch.float32), 7, 0.125),
     ValueError),
    (lambda: stencil3d.residual(_cube(7), _cube(9), 7, 0.125), ValueError),
    (lambda: stencil3d.residual(_cube(7), _cube(7), 9, 0.1), ValueError),
    (lambda: stencil3d.residual(_grid(7), _grid(7), 7, 0.125), ValueError),
    # bfloat16 storage is the stencil3d kernels' mixed mode: float16 is no
    # storage of theirs, and a bfloat16 sweep stores bfloat16 or float32.
    (lambda: stencil3d.rbgs_sweep(_cube(7, torch.float16),
                                  _cube(7, torch.float16), 7, 0.125),
     TypeError),
    (lambda: stencil3d.jacobi_sweep(_cube(7, torch.bfloat16),
                                    _cube(7, torch.bfloat16), 7, 0.125, 0.8,
                                    out_dtype=torch.float64),
     ValueError),
    (lambda: stencil3d.rbgs_sweep(_cube(7), _cube(7, torch.float32), 7,
                                  0.125), ValueError),
    (lambda: stencil2d.rbgs_sweep(_grid(7), _grid(7), 7, 0.125, sweeps=5),
     ValueError),
    (lambda: stencil2d.jacobi_sweep(_grid(7), _grid(9), 7, 0.125, 0.8),
     ValueError),
    (lambda: packed2d.rbgs_sweep(_packed(7), _packed(7), 7, 0.125,
                                 sweeps=5), ValueError),
    (lambda: packed2d.rbgs_sweep(_packed(7, torch.bfloat16),
                                 _packed(7, torch.float32), 7, 0.125),
     ValueError),
    # The packed legs' mixed modes: a float32 coarse correction (not
    # bfloat16), x' in x's dtype or float32; the fused residual norm's
    # bfloat16 mode takes bfloat16 u and b, not a float32 partner.
    (lambda: packed2d.prolong_add_smooth(
        _packed(7, torch.bfloat16), _grid(3, torch.bfloat16),
        _packed(7, torch.bfloat16), 7, 3, 0.125, kind="rbgs", omega=1.0,
        sweeps=1), TypeError),
    (lambda: packed2d.prolong_add_smooth(
        _packed(7, torch.bfloat16), _grid(3, torch.float32),
        _packed(7, torch.bfloat16), 7, 3, 0.125, kind="rbgs", omega=1.0,
        sweeps=1, out_dtype=torch.float64), ValueError),
    (lambda: packed2d.smooth_residual_restrict(
        _packed(7, torch.bfloat16), _packed(7, torch.float32), 7, 0.125,
        kind="rbgs", omega=1.0, sweeps=1), ValueError),
    (lambda: packed2d.residual_norm_sq(_packed(7, torch.bfloat16),
                                       _packed(7, torch.float32), 7, 0.125),
     ValueError),
    (lambda: transfer2d.residual_restrict(_grid(7), _grid(7, torch.float32),
                                          7, 0.125), ValueError),
    (lambda: transfer2d.prolong_add(_grid(7), _grid(4), 7, 3), ValueError),
    # bfloat16 is the SpMV's native mode, with x of the same dtype.
    (lambda: spmv.spmv_packed(_pdia(torch.bfloat16),
                              _px(torch.float32)), ValueError),
    (lambda: spmv.spmv_packed(_pdia(), _px(torch.float32)), ValueError),
    (lambda: spmv.spmv_packed(_pdia(), _px()[:-8]), ValueError),
    (lambda: spmv.spmv_packed(_pdia(), torch.zeros(_px().shape,
                                                   dtype=torch.float64,
                                                   device="meta")),
     ValueError),
    (lambda: spmv.spmv_packed(spmv.PackedDIA(_pdia().diags[:2], (-1, 0, 1),
                                             100), _px()), ValueError),
    (lambda: bell.spmm(_bell(torch.bfloat16),
                       torch.zeros((8, 256), dtype=torch.float32)),
     ValueError),
    (lambda: bell.spmm(_bell(), torch.zeros((8, 256), dtype=torch.float32)),
     ValueError),
    (lambda: bell.spmm(_bell(), torch.zeros((12, 256),
                                            dtype=torch.float64)),
     ValueError),
    (lambda: bell.spmm(_bell(), torch.zeros(256, dtype=torch.float64)),
     ValueError),
    (lambda: bell.spmm(_bell(), torch.zeros((8, 256), dtype=torch.float64,
                                            device="meta")), ValueError),
], ids=["dtype", "mixed-dtype", "shape", "non-contiguous", "down-cap",
        "down-kind", "even-n", "coarse-shape", "up-cap", "other-device",
        "packed-logical-input", "packed-down-cap", "packed-coarse-shape",
        "packed-up-cap", "packed-dtype", "packed-shape",
        "packed-residual-logical-input", "packed-residual-bf16",
        "stencil3d-shape", "stencil3d-n", "stencil3d-2d-input",
        "stencil3d-bf16", "stencil3d-out-dtype", "stencil3d-mixed-dtype",
        "sweep-cap", "sweep-shape", "packed-sweep-cap", "packed-sweep-bf16",
        "packed-up-bf16-e", "packed-up-out-dtype", "packed-down-bf16-b",
        "packed-resnorm-bf16", "transfer-mixed-dtype", "transfer-coarse-shape", "spmv-bf16",
        "spmv-mixed-dtype", "spmv-shape", "spmv-other-device",
        "spmv-diags-offsets", "bell-bf16", "bell-mixed-dtype", "bell-m",
        "bell-1d-input", "bell-other-device"])
def test_kernel_wrappers_reject_bad_inputs(bad, err):
    with pytest.raises(err):
        bad()
    assert (fused2d.down_launches, fused2d.up_launches,
            stencil2d.launches, stencil2d.rbgs_launches,
            stencil2d.jacobi_launches,
            transfer2d.residual_restrict_launches,
            transfer2d.prolong_add_launches, packed2d.down_launches,
            packed2d.up_launches, packed2d.resnorm_launches,
            packed2d.residual_launches, packed2d.rbgs_launches,
            stencil3d.residual_launches, stencil3d.jacobi_launches,
            stencil3d.rbgs_launches, spmv.launches, bell.launches,
            packed2d.down_bf16_launches, packed2d.up_bf16_launches,
            packed2d.up_bf16_f32_launches, packed2d.residual_bf16_launches,
            packed2d.rbgs_bf16_launches, packed2d.resnorm_bf16_launches,
            bell.bf16_launches) == (0,) * 24


def _solve(**kw):
    return mt.MultigridSolver(mt.poisson(device="cpu", **kw)).solve()


@pytest.mark.parametrize("kw,match", [
    # Ported since: run (their parity with JAX is in test_torch_chebyshev.py
    # and test_torch_fmg.py).
    (dict(k=4, ndim=2, smoother="chebyshev"), None),
    (dict(k=4, ndim=2, cycle="fmg"), None),
    # The 3D kernels store bfloat16 as a mixed cycle's fine level; a solve
    # in bfloat16 on them returns float32, which JAX's solve rejects.
    (dict(k=7, ndim=3, smoother="rbgs", use_kernels=True,
          dtype=torch.bfloat16), "stencil3d: .* JAX package's solve rejects"),
], ids=["kw0-Chebyshev", "kw1-fmg", "kw2-stencil3d"])
def test_unported_routes_raise(kw, match):
    if match is None:
        res = _solve(dtype=torch.float64, **kw)
        assert res.converged and mt.convergence_factor(res) < 0.2
        return
    with pytest.raises(NotImplementedError, match=match):
        _solve(**kw)


def _kernel_route_matches_plain(monkeypatch, **kw):
    """A float64 k=5 solve on the kernel route (the wrappers take their
    plain versions on CPU tensors) converges in the plain route's count to
    the plain route's iterate; returns the fine n of each transfer2d and
    packed2d.rbgs_sweep call it made."""
    calls = []
    for mod, name in ((transfer2d, "residual_restrict"),
                      (transfer2d, "prolong_add"),
                      (packed2d, "rbgs_sweep")):
        def spy(*a, _f=getattr(mod, name), **k):
            calls.append(a[2])
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    got, want = (_solve(k=5, ndim=2, dtype=torch.float64, tol=1e-9,
                        use_kernels=use, **kw) for use in (True, False))
    assert got.converged and got.iters == want.iters
    # rtol 1e-9: the packed down leg restricts the red residual only after
    # an RB-GS sweep (zero in exact arithmetic), the plain route both.
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=1e-9,
                               atol=1e-12)
    return calls


@pytest.mark.parametrize("kw,match", [
    (dict(smoother="chebyshev"), "Chebyshev"),
    (dict(smoother="rbgs", nu1=4), "stencil2d"),
    (dict(smoother="rbgs", nu2=5), "stencil2d"),
    (dict(smoother="jacobi", nu1=7), "transfer2d"),
])
def test_kernel_tier_raises_beyond_its_kernels(kw, match, monkeypatch):
    """Schedules no fused leg runs on the unpacked kernel tier (level 31)
    once raised (``match`` named the missing kernel); they now compose
    the leg from the stencil2d sweeps or residual and the transfer2d
    kernels."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    calls = _kernel_route_matches_plain(monkeypatch, **kw)
    assert calls and set(calls) == {31}


@pytest.mark.parametrize("kw,match", [
    (dict(smoother="chebyshev"), "Chebyshev"),
    (dict(smoother="rbgs", nu1=4), "packed2d"),
    (dict(smoother="jacobi", nu2=9), "packed2d"),
])
def test_packed_tier_raises_beyond_its_kernels(kw, match, monkeypatch):
    """The same on a packed fine level (31; ``match`` as above): the packed
    RB-GS sweep (RB-GS) or the packed residual (Chebyshev, Jacobi)
    smooths, and the zero-sweep packed legs restrict and prolong."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    monkeypatch.setattr(kernels, "PACK_MIN_N", 20)
    calls = _kernel_route_matches_plain(monkeypatch, **kw)
    assert calls == ([31] * len(calls) if kw["smoother"] == "rbgs" else [])
    assert bool(calls) == (kw["smoother"] == "rbgs")


def test_packed_level_runs_only_its_kernels(monkeypatch):
    """On a packed level every op of the backend stays in the packed
    layout where JAX's does: smoothing returns a packed grid with zero pad
    lanes, restriction the logical coarse grid (15 < PACK_MIN_N),
    prolongation onto the packed fine level a packed grid; each equals the
    plain op on the unpacked grids."""
    monkeypatch.setattr(kernels, "PACK_MIN_N", 20)
    bk = kernels.KERNEL_BACKEND
    rng = np.random.default_rng(3)
    u, b = (torch.zeros((33, 33), dtype=torch.float64) for _ in range(2))
    u[1:-1, 1:-1] = torch.from_numpy(rng.standard_normal((31, 31)))
    b[1:-1, 1:-1] = torch.from_numpy(rng.standard_normal((31, 31))) * 1024
    e = torch.zeros((17, 17), dtype=torch.float64)
    e[1:-1, 1:-1] = torch.from_numpy(rng.standard_normal((15, 15)))
    s, sb = bk.encode(u), bk.encode(b)
    assert packed2d.is_packed(s)
    assert not packed2d.is_packed(bk.encode(_grid(15)))
    assert torch.equal(bk.decode(s), u)
    r = bk.residual(s, sb, 31, 1 / 32)
    assert packed2d.is_packed(r)
    for kind, sweeps in (("rbgs", 5), ("jacobi", 3), ("chebyshev", 3)):
        got = bk.smooth(s, sb, 31, 1 / 32, kind=kind, omega=0.8,
                        sweeps=sweeps)
        assert packed2d.is_packed(got)
        assert torch.equal(packed2d.pack(packed2d.unpack(got)), got)
        want = smoothers.smooth(u, b, 1 / 32, kind=kind, omega=0.8,
                                sweeps=sweeps)
        np.testing.assert_allclose(bk.decode(got).numpy(), want.numpy(),
                                   rtol=1e-12, atol=1e-12 * 1024)
    rc = bk.restrict(s)
    assert rc.shape == (17, 17)
    np.testing.assert_allclose(rc.numpy(), transfer.restrict(u).numpy(),
                               rtol=1e-14, atol=1e-14)
    pe = bk.prolong(e, 15)
    assert packed2d.is_packed(pe)
    assert torch.equal(bk.decode(pe), transfer.prolong(e))
    assert bk.residual_norm2(_grid(15), _grid(15), 15, 1 / 16) is None
    assert bk.residual_norm2(_packed(31), _packed(31), 31, 1 / 32).item() \
        == 0.0


@pytest.mark.parametrize("kw", [dict(smoother="rbgs", nu1=4, nu2=5),
                                dict(smoother="jacobi", nu1=7, nu2=9)])
def test_long_schedules_run_below_the_kernel_tier(kw, monkeypatch):
    """Levels under KERNEL_MIN_N take the plain route, whatever the sweeps."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    res = _solve(k=4, ndim=2, dtype=torch.float64, use_kernels=True, tol=1e-6,
                 **kw)
    assert res.converged


def test_kernel_backend_smooth_raises_on_kernel_tier(monkeypatch):
    """Smoothing a kernel-tier level outside a fused leg once raised; it
    now runs the stencil2d sweeps in chunks of max_fused_sweeps (on a CPU
    tensor their plain versions) and equals the plain smoother. Zero
    sweeps return u itself, on and below the kernel tier."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 20)
    rng = np.random.default_rng(4)
    u, b = _grid(31), _grid(31)
    u[1:-1, 1:-1] = torch.from_numpy(rng.standard_normal((31, 31)))
    b[1:-1, 1:-1] = torch.from_numpy(rng.standard_normal((31, 31))) * 1024
    calls = []
    for name in ("rbgs_sweep", "jacobi_sweep"):
        def spy(*a, _f=getattr(stencil2d, name), **k):
            calls.append(k["sweeps"])
            return _f(*a, **k)
        monkeypatch.setattr(stencil2d, name, spy)
    for kind, sweeps, chunks in (("rbgs", 6, [4, 2]), ("jacobi", 9, [8, 1])):
        calls.clear()
        got = kernels.KERNEL_BACKEND.smooth(u, b, 31, 1 / 32, kind=kind,
                                            omega=0.8, sweeps=sweeps)
        assert calls == chunks
        assert torch.equal(got, smoothers.smooth(u, b, 1 / 32, kind=kind,
                                                 omega=0.8, sweeps=sweeps))
    for n in (31, 15):
        v = _grid(n)
        assert kernels.KERNEL_BACKEND.smooth(v, v, n, 1 / (n + 1),
                                             kind="rbgs", omega=1.0,
                                             sweeps=0) is v


@pytest.mark.parametrize("call", ["pcg", "eigensolve", "fmg", "as_csr",
                                  "as_coo"])
def test_unported_solver_methods_raise(call, monkeypatch):
    # Each is ported now and runs with a bfloat16 precond_dtype on the
    # packed tier. MG-PCG and the eigensolvers cast their cycles to it (2D
    # mixed precision) and reach the plain route's full-precision answer.
    # FMG reads no precond_dtype (as in JAX): it runs and equals the plain
    # route. as_csr/as_coo (ops/sparse.py) return the JAX package's
    # matrices.
    monkeypatch.setattr(kernels, "PACK_MIN_N", 7)
    solver = mt.MultigridSolver(mt.poisson2d(
        k=3, dtype=torch.float64, use_kernels=True,
        precond_dtype=torch.bfloat16, device="cpu"))
    if call == "fmg":
        plain = mt.MultigridSolver(mt.poisson2d(
            k=3, dtype=torch.float64, precond_dtype=torch.bfloat16,
            device="cpu"))
        got, want = solver.fmg(), plain.fmg()
        assert not packed2d.is_packed(got)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-14)
        return
    if call in ("as_csr", "as_coo"):
        import jax.numpy as jnp

        import multigridcmt_tpu as jmg

        got = getattr(solver, call)()
        want = getattr(jmg.MultigridSolver(jmg.poisson2d(
            k=3, dtype=jnp.float64)), call)()
        assert got.shape == tuple(want.shape) == (49, 49)
        assert got.nnz == want.nnz == 5 * 49 - 4 * 7
        fields = (("data", "indices", "indptr", "row_ids") if call == "as_csr"
                  else ("data", "row", "col"))
        for f in fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        return
    plain = mt.MultigridSolver(mt.poisson2d(k=3, dtype=torch.float64,
                                            device="cpu"))
    if call == "pcg":
        got, want = solver.solve(method="pcg"), plain.solve(method="pcg")
        assert got.converged and got.x.dtype == torch.float64
        np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                                   atol=1e-8 * want.x.abs().max().item())
    else:
        got, want = solver.eigensolve(), plain.eigensolve()
        assert got.converged
        np.testing.assert_allclose(got.eigenvalues.numpy(),
                                   want.eigenvalues.numpy(), rtol=1e-8)


@pytest.mark.parametrize("item", ["sharded 3D slabs and pencils",
                                  "sharded mixed precision", "utils"])
def test_remaining_items_raise_naming_them(item, monkeypatch, request):
    """Each item that once raised NotImplementedError naming its ROADMAP.md
    item is ported now, and runs. Sharded 3D slabs and pencils: on a world
    of 1, a slab mesh and a pencil mesh each run the extended-stack level
    (the stencil3d kernels' plain versions here) and converge in the
    single-device solve's cycles to its answer. Sharded mixed precision in
    3D: MG-PCG with a bfloat16 preconditioner casts where mixed_slab_dtype
    says and reaches the full-dtype answer (their parity with JAX is in
    test_torch_sharded3d.py and test_torch_sharded3d_mixed.py). The utils:
    profiling.trace writes a trace of a k=3 solve with a range for each
    level, and Timer brackets it with its fence (the rest of the utils are
    held against JAX in test_torch_utils.py)."""
    from multigridcmt_tpu_torch.parallel import sharded
    from multigridcmt_tpu_torch.utils import profiling

    if item == "utils":
        import json

        tmp = request.getfixturevalue("tmp_path")
        prob = mt.poisson2d(k=3, dtype=torch.float64, device="cpu")
        with profiling.trace(str(tmp)), profiling.Timer() as timer:
            res = mt.MultigridSolver(prob).solve()
            total = profiling.Timer.fence(res.x)
        assert res.converged and total == res.x.sum().item()
        assert timer.elapsed > 0
        (path,) = tmp.glob("*.pt.trace.json")
        names = {e.get("name") for e in json.loads(path.read_text())[
            "traceEvents"]}
        assert {f"mg_level_{i}" for i in range(
            prob.hierarchy.num_levels)} <= names
        return
    request.getfixturevalue("world_of_one")
    request.getfixturevalue("one_thread")
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", 30)
    kw = dict(k=5, dtype=torch.float64, smoother="rbgs", use_kernels=True,
              agglom_rows=4, tol=1e-9)
    b = mt.poisson3d(device="cpu", **kw).b
    meshes = (sharded.make_mesh(device="cpu"),
              sharded.make_block_mesh((1, 1), device="cpu"))
    for mesh in meshes:
        if item == "sharded mixed precision":
            mixed = sharded.ShardedSolver(
                SolverConfig(ndim=3, precond_dtype=torch.bfloat16, **kw),
                mesh)
            assert sharded.mixed_slab_dtype(mixed.config, mixed.decomp) == \
                torch.bfloat16
            got = mixed.solve(b, method="pcg")
            want = sharded.ShardedSolver(SolverConfig(ndim=3, **kw),
                                         mesh).solve(b, method="pcg")
            assert got.converged and want.converged
            assert got.x.dtype == torch.float64
            np.testing.assert_allclose(got.x.numpy(), want.x.numpy(),
                                       rtol=1e-7, atol=1e-8)
            continue
        s = sharded.ShardedSolver(SolverConfig(ndim=3, **kw), mesh)
        x = torch.zeros((32, 33 if len(mesh.shape) == 1 else 32, 33))
        assert sharded._slab3d_ok(x, 31, "rbgs", s.decomp, 5) or \
            sharded._pencil3d_ok(x, 31, s.config, s.decomp)
        got = s.solve(b)
        want = mt.MultigridSolver(mt.poisson3d(device="cpu", **kw)).solve()
        assert got.converged and got.iters == want.iters
        np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                                   atol=1e-10)


# ---------------------------------------------------------------------------
# The sharded slice: parallel/sharded.py and kernels/local2d.py
# ---------------------------------------------------------------------------

def test_import_guard_covers_parallel():
    """test_port_imports_no_jax walks the whole package, parallel/ and the
    local2d wrappers included, and the utils and the example CLIs."""
    covered = set(PORT.rglob("*.py"))
    for rel in ("parallel/__init__.py", "parallel/sharded.py",
                "kernels/local2d.py", "kernels/plocal2d.py",
                "utils/checkpoint.py", "utils/comm_audit.py",
                "utils/debug.py", "utils/metrics.py", "utils/plots.py",
                "examples/__init__.py", "examples/distributed_vcycle.py",
                "examples/eigensolve.py", "examples/fmg_accuracy.py",
                "examples/poisson1d_vcycle.py", "examples/poisson2d_rbgs.py",
                "examples/poisson3d.py"):
        assert PORT / rel in covered


def test_make_mesh_needs_a_process_group():
    from multigridcmt_tpu_torch.parallel import sharded

    assert not torch.distributed.is_initialized()
    for call in (lambda: sharded.make_mesh(device="cpu"),
                 lambda: sharded.make_block_mesh((1, 1), device="cpu")):
        with pytest.raises(RuntimeError, match="init_process_group"):
            call()


def _fake_cuda_tiles():
    """Fake CUDA tensors (no data, no card needed): a 4x2-rank block tile
    of 63^2 and its coarse tile."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    with mode:
        u = torch.zeros((32, 32), dtype=torch.float64, device="cuda")
        e = torch.zeros((24, 24), dtype=torch.float64, device="cuda")
    return mode, u, e


def test_local2d_wrappers_raise_on_cuda_without_a_card():
    """A CUDA tensor takes the kernel route, which raises with no card; it
    never runs the plain version, and no launch is counted."""
    import warnings

    from multigridcmt_tpu_torch.kernels import local2d

    mode, u, e = _fake_cuda_tiles()
    kw = dict(kind="rbgs", omega=1.0, sweeps=2, mcol=16)
    calls = [lambda: local2d.rbgs_sweep(u, u, 63, 1 / 64, -7, -7, sweeps=2),
             lambda: local2d.jacobi_sweep(u, u, 63, 1 / 64, 0.8, -7, -7),
             lambda: local2d.residual(u, u, 63, 1 / 64, -7, -7),
             lambda: local2d.down_leg(u, u, 63, 1 / 64, 16, -7, -7, **kw),
             lambda: local2d.up_leg(u, e, u, 63, 31, 1 / 64, 16, -7, -7,
                                    **kw)]
    with mode, warnings.catch_warnings():
        warnings.simplefilter("ignore")   # data_ptr of a fake tensor
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
    assert (local2d.rbgs_launches, local2d.jacobi_launches,
            local2d.residual_launches, local2d.down_launches,
            local2d.up_launches) == (0,) * 5


def _packed_tiles(device, dtype=torch.float64):
    """A row tile of 63^2 (m = 16) packed, b, and its coarse tile."""
    u = torch.zeros((2, 32, 33), dtype=dtype, device=device)
    return u, u.clone(), torch.zeros((24, 33), dtype=dtype, device=device)


def _plocal2d_calls(u, b, e):
    from multigridcmt_tpu_torch.kernels import plocal2d

    kw = dict(kind="rbgs", omega=1.0, sweeps=2)
    h = 1 / 64
    return {
        "residual": (lambda: plocal2d.residual(u, b, 63, h, -7),
                     lambda: plocal2d.residual_plain(u, b, 63, h, -7)),
        "apply_op": (lambda: plocal2d.apply_op(u, 63, h, -7),
                     lambda: plocal2d.apply_op_plain(u, 63, h, -7)),
        "down_leg": (lambda: plocal2d.down_leg(u, b, 63, h, 16, -7, **kw),
                     lambda: plocal2d.down_leg_plain(u, b, 63, h, 16, -7,
                                                     **kw)),
        "up_leg": (lambda: plocal2d.up_leg(u, e, b, 63, 31, h, 16, -7, **kw),
                   lambda: plocal2d.up_leg_plain(u, e, b, 63, 31, h, 16, -7,
                                                 **kw)),
        "residual_norm_sq": (
            lambda: plocal2d.residual_norm_sq(u, b, 63, h, 16, -7),
            lambda: plocal2d.residual_norm_sq_plain(u, b, 63, h, 16, -7)),
    }


def _plocal2d_launches():
    from multigridcmt_tpu_torch.kernels import plocal2d

    return (plocal2d.residual_launches, plocal2d.apply_launches,
            plocal2d.down_launches, plocal2d.up_launches,
            plocal2d.resnorm_launches, plocal2d.residual_bf16_launches,
            plocal2d.apply_bf16_launches, plocal2d.resnorm_bf16_launches,
            plocal2d.down_bf16_launches, plocal2d.up_bf16_launches,
            plocal2d.up_bf16_f32_launches)


@pytest.mark.parametrize("device", ["cpu", "fake-cuda", "bf16"])
def test_plocal2d_wrappers_follow_the_device_rule(device):
    """A CPU tensor takes the plain version (no launch counted); a CUDA
    tensor takes the kernel route, which raises with no card and never runs
    the plain version; bfloat16 storage takes the plain versions on a CPU
    tensor too (the legs with a float32 coarse correction)."""
    import warnings

    if device == "cpu":
        gen = torch.Generator().manual_seed(1)
        u, b, e = (torch.randn(t.shape, generator=gen, dtype=torch.float64)
                   for t in _packed_tiles("cpu"))
        u[..., -1] = b[..., -1] = 0.0     # a row tile's pad lanes
        for name, (call, plain) in _plocal2d_calls(u, b, e).items():
            got, want = call(), plain()
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                assert torch.equal(g, w), name
    elif device == "bf16":
        u, b, _ = _packed_tiles("cpu", torch.bfloat16)
        e = _packed_tiles("cpu", torch.float32)[2]
        for name, (call, plain) in _plocal2d_calls(u, b, e).items():
            got, want = call(), plain()
            for g, w in zip(*((got, want) if isinstance(got, tuple)
                              else ((got,), (want,)))):
                assert torch.equal(g, w), name
    else:
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = FakeTensorMode()
        with mode:
            tiles = _packed_tiles("cuda")
        with mode, warnings.catch_warnings():
            warnings.simplefilter("ignore")   # data_ptr of a fake tensor
            for call, _ in _plocal2d_calls(*tiles).values():
                with pytest.raises(RuntimeError):
                    call()
    assert _plocal2d_launches() == (0,) * 11


def _tile(rows=32, cols=32, dtype=torch.float64):
    return torch.zeros((rows, cols), dtype=dtype)


@pytest.mark.parametrize("bad,err", [
    (lambda: _l2().rbgs_sweep(_tile(), _tile(), 63, 1 / 64, -7, sweeps=5),
     ValueError),
    (lambda: _l2().jacobi_sweep(_tile(), _tile(), 63, 1 / 64, 0.8, -7,
                                sweeps=0), ValueError),
    (lambda: _l2().residual(_tile(), _tile(dtype=torch.float32), 63,
                            1 / 64, -7), ValueError),
    # bfloat16 is the residual's native mode, with b of the same dtype.
    (lambda: _l2().residual(_tile(dtype=torch.bfloat16),
                            _tile(dtype=torch.float32), 63, 1 / 64, -7),
     ValueError),
    (lambda: _l2().down_leg(_tile(), _tile(), 63, 1 / 64, 16, -7, kind="rbgs",
                            omega=1.0, sweeps=4), ValueError),
    (lambda: _l2().down_leg(_tile(), _tile(), 63, 1 / 64, 16, -7,
                            kind="chebyshev", omega=1.0, sweeps=1),
     ValueError),
    (lambda: _l2().down_leg(_tile(32, 65), _tile(32, 65), 63, 1 / 64, 18, -7,
                            kind="rbgs", omega=1.0, sweeps=1), ValueError),
    (lambda: _l2().up_leg(_tile(32, 65), _tile(24, 32), _tile(32, 65), 63,
                          31, 1 / 64, 16, -7, kind="rbgs", omega=1.0,
                          sweeps=1), ValueError),
    (lambda: _l2().up_leg(_tile(32, 65), _tile(24, 33), _tile(32, 65), 63,
                          31, 1 / 64, 16, -7, kind="jacobi", omega=0.8,
                          sweeps=7), ValueError),
    # A wider x' is the bfloat16 legs' mode only (float32 for bfloat16 x).
    (lambda: _l2().up_leg(_tile(32, 65), _tile(24, 33), _tile(32, 65), 63,
                          31, 1 / 64, 16, -7, kind="rbgs", omega=1.0,
                          sweeps=1, out_dtype=torch.float32),
     ValueError),
], ids=["sweep-cap", "zero-sweeps", "mixed-dtype", "bf16", "down-cap",
        "down-kind", "tile-shape", "coarse-shape", "up-cap", "out-dtype"])
def test_local2d_wrappers_reject_bad_inputs(bad, err):
    from multigridcmt_tpu_torch.kernels import local2d

    with pytest.raises(err):
        bad()
    assert (local2d.rbgs_launches, local2d.jacobi_launches,
            local2d.residual_launches, local2d.down_launches,
            local2d.up_launches) == (0,) * 5


def _l2():
    from multigridcmt_tpu_torch.kernels import local2d

    return local2d


@pytest.fixture
def one_thread():
    """torch on one thread for the test: the 3D solves' small grids run
    ~30x slower split over the cores' threads here."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, destroyed after the
    test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sharded_solver(**kw):
    from multigridcmt_tpu_torch.parallel import sharded

    cfg = SolverConfig(ndim=kw.pop("ndim", 2), dtype=torch.float64,
                       smoother="rbgs", use_kernels=True, agglom_rows=4, **kw)
    return sharded.ShardedSolver(cfg, sharded.make_mesh(device="cpu"))


@pytest.mark.parametrize("call,item", [
    ("eigensolve", "sharded eigensolvers"),
    ("fmg", "sharded fmg"),
    ("ndim3", "sharded 3D slabs and pencils"),
    ("precond_dtype", "mixed precision"),
    ("pcg_precond_dtype", "mixed precision"),
    ("eigensolve_precond_dtype", "sharded eigensolvers"),
])
def test_unported_sharded_routes_raise(call, item, world_of_one,
                                       monkeypatch, request):
    """Each names its ROADMAP.md item; none reroutes. The sharded FMG is
    ported since: it runs (on the packed route here) and converges, in the
    single-device FMG solve's count (its parity with JAX is in
    test_torch_sharded_fmg.py). So is 2D sharded mixed precision: the solve
    by cycles reads no precond_dtype (as in JAX) and equals the full-dtype
    solve; MG-PCG casts its cycle to bfloat16 on the packed route and
    reaches the full-dtype answer (its parity with JAX is in
    test_torch_mixed_sharded_solve.py). So are the sharded eigensolvers,
    with a precond_dtype as without: inverse iteration on the packed route
    takes the single-device eigensolve's outer steps to its eigenvalue
    (rtol 1e-10, the eigenvector up to sign), and with a bfloat16
    preconditioner (inner refinement) reaches it within 1e-8 (their parity
    with JAX is in test_torch_sharded_eigen.py)."""
    from multigridcmt_tpu_torch.parallel import sharded

    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 30)
    monkeypatch.setattr(kernels, "PACK_MIN_N", 60)
    b = mt.poisson2d(k=6, dtype=torch.float64, device="cpu").b
    if call == "fmg":
        got = _sharded_solver(k=6, cycle="fmg", tol=1e-9).solve(b)
        want = mt.MultigridSolver(mt.poisson2d(
            k=6, dtype=torch.float64, smoother="rbgs", use_kernels=True,
            agglom_rows=4, cycle="fmg", tol=1e-9, device="cpu")).solve()
        assert got.converged and got.iters == want.iters
        np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                                   atol=1e-10)
        return
    if call in ("precond_dtype", "pcg_precond_dtype"):
        method = "pcg" if call == "pcg_precond_dtype" else "mg"
        mixed = _sharded_solver(k=6, tol=1e-9, precond_dtype=torch.bfloat16)
        assert sharded.mixed_leg_dtype(mixed.config, mixed.decomp) == \
            torch.bfloat16
        got = mixed.solve(b, method=method)
        want = _sharded_solver(k=6, tol=1e-9).solve(b, method=method)
        assert got.converged and want.converged
        assert got.x.dtype == torch.float64
        if method == "mg":
            assert got.iters == want.iters
            assert torch.equal(got.x, want.x)
        else:
            np.testing.assert_allclose(got.x.numpy(), want.x.numpy(),
                                       rtol=1e-7, atol=1e-8)
        return
    if call in ("eigensolve", "eigensolve_precond_dtype"):
        pd = torch.bfloat16 if call == "eigensolve_precond_dtype" else None
        s = _sharded_solver(k=6, precond_dtype=pd)
        assert sharded._pack_level_ok(s.config, s.decomp, 0)
        assert sharded.mixed_leg_dtype(s.config, s.decomp) == pd
        got = s.eigensolve(k=1)
        want = mt.MultigridSolver(mt.poisson2d(
            k=6, dtype=torch.float64, smoother="rbgs", use_kernels=True,
            device="cpu")).eigensolve(k=1)
        assert got.converged and want.converged
        lam, ref = got.eigenvalues[0].item(), want.eigenvalues[0].item()
        if pd is None:
            assert got.iters == want.iters
            assert abs(lam - ref) <= 1e-10 * ref
            g, w = got.eigenvectors[0], want.eigenvectors[0]
            sign = torch.sign(torch.sum(g * w)).item()
            np.testing.assert_allclose(sign * g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-8)
        else:
            assert got.iters <= want.iters + 3
            assert abs(lam - ref) <= 1e-8 * ref
        return
    # Sharded 3D (ndim3) is ported since: a slab solve on the world of 1
    # runs the stencil3d tier (KERNEL3_MIN_N lowered) and takes the
    # single-device solve's cycles to its answer.
    request.getfixturevalue("one_thread")
    monkeypatch.setattr(kernels, "KERNEL3_MIN_N", 30)
    b3 = mt.poisson3d(k=5, dtype=torch.float64, device="cpu").b
    got = _sharded_solver(k=5, ndim=3, tol=1e-9).solve(b3)
    want = mt.MultigridSolver(mt.poisson3d(
        k=5, dtype=torch.float64, smoother="rbgs", use_kernels=True,
        agglom_rows=4, tol=1e-9, device="cpu")).solve()
    assert got.converged and got.iters == want.iters
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=0,
                               atol=1e-10)


def _native_inputs(shape, seed):
    """bfloat16 u and b of ``shape``, N(0, 1) and N(0, 64^2)."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen).to(torch.bfloat16),
            (torch.randn(shape, generator=gen) * 4096.0).to(torch.bfloat16))


@pytest.mark.parametrize("call", [
    "local2d.residual", "local2d.rbgs_sweep", "local2d.jacobi_sweep",
    "stencil2d.residual", "stencil2d.rbgs_sweep", "stencil2d.jacobi_sweep",
    "spmv.spmv_packed", "fused2d.smooth_residual_restrict",
    "fused2d.prolong_add_smooth", "transfer2d.residual_restrict",
    "transfer2d.prolong_add"])
def test_native_bf16_wrappers_run(call):
    """The native bfloat16 modes run on a CPU tensor: each wrapper equals
    its plain version bit for bit (sigma 1.3, which bfloat16 does not hold)
    and launches nothing."""
    from multigridcmt_tpu_torch.kernels import local2d, native_bf16

    h, sigma, omega = 1 / 64, 1.3, 0.8
    u, b = _native_inputs((32, 40), 7)
    g, gb = _native_inputs((65, 65), 8)
    e = _native_inputs((33, 33), 10)[0]
    c = native_bf16.constants(h, sigma, omega)
    c0 = native_bf16.constants(h)
    pk = spmv.PackedDIA(_pdia().diags.to(torch.bfloat16), (-1, 0, 1), 100)
    x = _native_inputs((24, 128), 9)[0]
    x[:8], x[-8:] = 0, 0
    calls = {
        "local2d.residual": (
            lambda: local2d.residual(u, b, 63, h, -7, 9, sigma=sigma),
            lambda: native_bf16.residual_plain(u, b, 63, c, -7, 9)),
        "local2d.rbgs_sweep": (
            lambda: local2d.rbgs_sweep(u, b, 63, h, -7, 9, sigma=sigma,
                                       sweeps=3),
            lambda: native_bf16.sweep_plain("rbgs", u, b, 63, c, 3, -7, 9)),
        "local2d.jacobi_sweep": (
            lambda: local2d.jacobi_sweep(u, b, 63, h, omega, -7, 9,
                                         sigma=sigma, sweeps=5),
            lambda: native_bf16.sweep_plain("jacobi", u, b, 63, c, 5, -7,
                                            9)),
        "stencil2d.residual": (
            lambda: stencil2d.residual(g, gb, 63, h, sigma=sigma),
            lambda: native_bf16.residual_plain(g, gb, 63, c)),
        "stencil2d.rbgs_sweep": (
            lambda: stencil2d.rbgs_sweep(g, gb, 63, h, sigma=sigma,
                                         sweeps=2),
            lambda: native_bf16.sweep_plain("rbgs", g, gb, 63, c, 2)),
        "stencil2d.jacobi_sweep": (
            lambda: stencil2d.jacobi_sweep(g, gb, 63, h, omega, sigma=sigma,
                                           sweeps=8),
            lambda: native_bf16.sweep_plain("jacobi", g, gb, 63, c, 8)),
        "spmv.spmv_packed": (lambda: spmv.spmv_packed(pk, x),
                             lambda: spmv.spmv_packed_plain(pk, x)),
        "fused2d.smooth_residual_restrict": (
            lambda: fused2d.smooth_residual_restrict(
                g, gb, 63, h, kind="jacobi", omega=omega, sweeps=5,
                sigma=sigma),
            lambda: native_bf16.down_leg_plain(g, gb, 63, c, "jacobi", 5)),
        "fused2d.prolong_add_smooth": (
            lambda: fused2d.prolong_add_smooth(
                g, e, gb, 63, 31, h, kind="rbgs", omega=1.0, sweeps=3,
                sigma=sigma),
            lambda: native_bf16.up_leg_plain(g, e, gb, 63, 31, c, "rbgs",
                                             3)),
        "transfer2d.residual_restrict": (
            lambda: transfer2d.residual_restrict(g, gb, 63, h),
            lambda: native_bf16.residual_restrict_plain(g, gb, 63, c0,
                                                        False)),
        "transfer2d.prolong_add": (
            lambda: transfer2d.prolong_add(g, e, 63, 31),
            lambda: native_bf16.prolong_add_plain(g, e, 63, 31, False)),
    }
    run, plain = calls[call]
    got, want = run(), plain()
    for got, want in zip(*(t if isinstance(t, tuple) else (t,)
                           for t in (got, want))):
        assert got.dtype == want.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert (local2d.residual_bf16_launches, local2d.rbgs_bf16_launches,
            local2d.jacobi_bf16_launches, stencil2d.residual_bf16_launches,
            stencil2d.rbgs_bf16_launches, stencil2d.jacobi_bf16_launches,
            spmv.bf16_launches, fused2d.down_bf16_launches,
            fused2d.up_bf16_launches,
            transfer2d.residual_restrict_bf16_launches,
            transfer2d.prolong_add_bf16_launches) == (0,) * 11


@pytest.mark.parametrize("call", [
    "plocal2d.residual", "plocal2d.apply_op", "plocal2d.residual_norm_sq"])
def test_cdt_bf16_tile_wrappers_run_plain(call):
    """The packed tile's residual, apply and norm take bfloat16 tiles (the
    JAX kernels' _cdt rule): on a CPU tensor each equals its plain version
    (a bfloat16 tile for the residual and apply, a float32 scalar for the
    norm) and launches nothing."""
    from multigridcmt_tpu_torch.kernels import plocal2d

    gen = torch.Generator().manual_seed(2)
    s, b = (torch.randn((2, 32, 33), generator=gen).to(torch.bfloat16)
            for _ in range(2))
    s[..., -1] = b[..., -1] = 0.0      # a row tile's pad lanes
    h = 1 / 64
    calls = {
        "plocal2d.residual": (
            lambda: plocal2d.residual(s, b, 63, h, -7, sigma=2.0),
            lambda: plocal2d.residual_plain(s, b, 63, h, -7, sigma=2.0)),
        "plocal2d.apply_op": (
            lambda: plocal2d.apply_op(s, 63, h, -7, sigma=2.0),
            lambda: plocal2d.apply_op_plain(s, 63, h, -7, sigma=2.0)),
        "plocal2d.residual_norm_sq": (
            lambda: plocal2d.residual_norm_sq(s, b, 63, h, 16, -7),
            lambda: plocal2d.residual_norm_sq_plain(s, b, 63, h, 16, -7)),
    }
    run, plain = calls[call]
    got, want = run(), plain()
    assert got.dtype == (torch.float32 if call.endswith("norm_sq")
                         else torch.bfloat16)
    assert torch.equal(got, want)
    assert _plocal2d_launches() == (0,) * 11


@pytest.mark.parametrize("method,pack_min_n", [
    ("mg", 60), ("pcg", 60), ("pcg", 64)],
    ids=["packed", "pcg-packed", "pcg"])
def test_packed_and_pcg_sharded_routes_run(method, pack_min_n, world_of_one,
                                           monkeypatch):
    """On a mesh of 1 the packed solve (the 63 level on plocal2d, PACK_MIN_N
    60) and sharded MG-PCG, packed and not, equal the port's single-device
    solve with the same thresholds: equal iterations, histories to rtol
    1e-10 down to the rounding floor (1e-12)."""
    from multigridcmt_tpu_torch.parallel import sharded

    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 30)
    monkeypatch.setattr(kernels, "PACK_MIN_N", pack_min_n)
    prob = mt.poisson2d(k=6, dtype=torch.float64, smoother="rbgs",
                        use_kernels=True, agglom_rows=4, tol=1e-9,
                        device="cpu")
    solver = _sharded_solver(k=6, tol=1e-9)
    assert sharded._pack_level_ok(solver.config, solver.decomp, 0) == (
        pack_min_n <= 63)
    got = solver.solve(prob.b, method=method)
    want = mt.MultigridSolver(prob).solve(method=method)
    assert got.converged and got.iters == want.iters
    np.testing.assert_allclose(got.res_history.numpy(),
                               want.res_history.numpy(), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=1e-8,
                               atol=1e-12)


def test_packed_threshold_is_read_when_called(world_of_one, monkeypatch):
    """Above the fine n, PACK_MIN_N lets the unpacked leg route run: a
    mesh-of-1 sharded solve equals the port's single-device solve."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 30)
    monkeypatch.setattr(kernels, "PACK_MIN_N", 64)
    prob = mt.poisson2d(k=6, dtype=torch.float64, smoother="rbgs",
                        use_kernels=True, agglom_rows=4, tol=1e-9,
                        device="cpu")
    got = _sharded_solver(k=6, tol=1e-9).solve(prob.b)
    want = mt.MultigridSolver(prob).solve()
    assert got.converged and got.iters == want.iters
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=1e-8,
                               atol=1e-12)


def test_sharded_warm_start(world_of_one, monkeypatch):
    """x0 warm-starts the sharded solve (its ghosts are stripped): from a
    converged x it takes no cycle; from a perturbed one it converges to the
    same solution."""
    monkeypatch.setattr(kernels, "KERNEL_MIN_N", 30)
    monkeypatch.setattr(kernels, "PACK_MIN_N", 64)
    solver = _sharded_solver(k=6, tol=1e-9)
    b = mt.poisson2d(k=6, dtype=torch.float64, device="cpu").b
    first = solver.solve(b)
    again = solver.solve(b, x0=first.x)
    assert again.iters == 0 and again.converged
    x0 = first.x + 1.0          # nonzero ghosts too: stripped
    warm = solver.solve(b, x0=x0)
    assert warm.converged
    np.testing.assert_allclose(warm.x.numpy(), first.x.numpy(), rtol=0,
                               atol=1e-9 * first.x.abs().max().item())


def _chip_smoke_rows(module: str) -> dict:
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert len(smoke.KERNELS) == 59
    return {name: row for name, row in smoke.KERNELS.items()
            if row[0] == module}


def _check_listed(module: str, lines, sources=None) -> None:
    """Each of ``module``'s float32/float64 rows (its bfloat16 modes
    apart) names its TPU kernel and its CUDA source: csrc/<module>.cu, or
    csrc/<sources[name]>.cu where given."""
    rows = {name: row for name, row in _chip_smoke_rows(module).items()
            if "bf16" not in name}
    assert sorted(r[3] for r in rows.values()) == sorted(
        f"multigridcmt_tpu/kernels/{module}.py:{line}" for line in lines)
    sources = sources or {}
    assert all(r[2] == "multigridcmt_tpu_torch/kernels/csrc/"
               f"{sources.get(name, module)}.cu"
               for name, r in rows.items())


def test_chip_smoke_lists_the_local2d_kernels():
    """The five local2d entry points; the legs are built from
    csrc/local2d_legs.cu, the sweeps from csrc/local2d_sweep.cu and the
    residual from csrc/local2d.cu."""
    _check_listed("local2d", (263, 278, 289, 616, 843),
                  {"local2d_down": "local2d_legs",
                   "local2d_up": "local2d_legs",
                   "local2d_rbgs": "local2d_sweep",
                   "local2d_jacobi": "local2d_sweep"})


def test_chip_smoke_lists_the_plocal2d_kernels():
    """The five plocal2d entry points, each on the path that launches it on
    the card: the legs and the norm on S1, the residual and the apply on
    S1pcg; the legs are built from csrc/plocal2d_legs.cu."""
    _check_listed("plocal2d", (262, 501, 708, 855, 982),
                  {"plocal2d_down": "plocal2d_legs",
                   "plocal2d_up": "plocal2d_legs"})
    rows = _chip_smoke_rows("plocal2d")
    assert {name: row[4] for name, row in rows.items()
            if "bf16" not in name} == {
        "plocal2d_down": "S1", "plocal2d_up": "S1", "plocal2d_resnorm": "S1",
        "plocal2d_residual": "S1pcg", "plocal2d_apply": "S1pcg"}


def test_chip_smoke_lists_the_packed2d_bf16_modes():
    """The packed2d kernels' bfloat16 modes, each built from a file of its
    own and on the mixed path that launches it on the card (the up leg's
    bfloat16 store and the norm, which no solver runs, by direct calls)."""
    rows = {name: row for name, row in _chip_smoke_rows("packed2d").items()
            if "bf16" in name}
    src = "multigridcmt_tpu_torch/kernels/csrc/"
    tpu = "multigridcmt_tpu/kernels/packed2d.py:"
    assert {name: row[1:] for name, row in rows.items()} == {
        "packed2d_down_bf16": ("down_bf16_launches", src + "packed2d_bf16.cu",
                               tpu + "839", "mixed2d"),
        "packed2d_up_bf16_f32": ("up_bf16_f32_launches",
                                 src + "packed2d_up_bf16_f32.cu",
                                 tpu + "1067", "mixed2d"),
        "packed2d_up_bf16": ("up_bf16_launches", src + "packed2d_up_bf16.cu",
                             tpu + "1067", None),
        "packed2d_rbgs_bf16": ("rbgs_bf16_launches",
                               src + "packed2d_sweep_bf16.cu", tpu + "305",
                               "mixedB"),
        "packed2d_residual_bf16": ("residual_bf16_launches",
                                   src + "packed2d_bf16.cu", tpu + "440",
                                   "mixedA"),
        "packed2d_resnorm_bf16": ("resnorm_bf16_launches",
                                  src + "packed2d_bf16.cu", tpu + "553",
                                  None)}
    for name, row in rows.items():
        assert hasattr(packed2d, row[1])
        assert (ROOT / row[2]).is_file()


@pytest.mark.parametrize("module,lines,run", [
    ("local2d", (616, 843), "S1unpacked-mixed"),
    ("plocal2d", (501, 708), "S1mixed")])
def test_chip_smoke_lists_the_tile_bf16_modes(module, lines, run):
    """The shard tile legs' bfloat16 modes: the down leg and the up leg
    storing bfloat16 from csrc/<module>_legs_bf16.cu, the up leg storing
    float32 from csrc/<module>_up_bf16_f32.cu; the down leg and the
    float32-storing up leg on the sharded mixed path that runs them on the
    card, the bfloat16-storing up leg (which no solver runs) by direct
    calls. (plocal2d's residual, apply and norm in bfloat16: the next
    test.)"""
    rows = {name: row for name, row in _chip_smoke_rows(module).items()
            if "bf16" in name and ("_down" in name or "_up" in name)}
    src = f"multigridcmt_tpu_torch/kernels/csrc/{module}_"
    tpu = f"multigridcmt_tpu/kernels/{module}.py:"
    down, up = lines
    assert {name: row[1:] for name, row in rows.items()} == {
        f"{module}_down_bf16": ("down_bf16_launches", src + "legs_bf16.cu",
                                f"{tpu}{down}", run),
        f"{module}_up_bf16_f32": ("up_bf16_f32_launches",
                                  src + "up_bf16_f32.cu", f"{tpu}{up}", run),
        f"{module}_up_bf16": ("up_bf16_launches", src + "legs_bf16.cu",
                              f"{tpu}{up}", None)}
    mod = importlib.import_module(f"multigridcmt_tpu_torch.kernels.{module}")
    for row in rows.values():
        assert hasattr(mod, row[1]) and (ROOT / row[2]).is_file()


def test_chip_smoke_lists_the_cdt_bf16_modes():
    """The bfloat16 modes that no path of either package runs, ported by
    the _cdt rule: the packed tile's residual, apply and norm (from
    csrc/plocal2d_bf16.cu), the whole grid's norm (csrc/packed2d_bf16.cu)
    and the BELL SpMM (csrc/bell.cu), each with its TPU function, counted
    apart from its float twin and launched once by its direct run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    src = "multigridcmt_tpu_torch/kernels/csrc/"
    tpu = "multigridcmt_tpu/kernels/"
    want = {
        "plocal2d_residual_bf16": ("plocal2d", "residual_bf16_launches",
                                   src + "plocal2d_bf16.cu",
                                   tpu + "plocal2d.py:262", None),
        "plocal2d_apply_bf16": ("plocal2d", "apply_bf16_launches",
                                src + "plocal2d_bf16.cu",
                                tpu + "plocal2d.py:982", None),
        "plocal2d_resnorm_bf16": ("plocal2d", "resnorm_bf16_launches",
                                  src + "plocal2d_bf16.cu",
                                  tpu + "plocal2d.py:855", None),
        "packed2d_resnorm_bf16": ("packed2d", "resnorm_bf16_launches",
                                  src + "packed2d_bf16.cu",
                                  tpu + "packed2d.py:553", None),
        "bell_spmm_bf16": ("bell", "bf16_launches", src + "bell.cu",
                           tpu + "bell.py:180", None)}
    assert {name: smoke.KERNELS[name] for name in want} == want
    assert {smoke.DIRECT_RUNS[name] for name in want} == {"cdt_bf16_direct"}
    for mod, counter, source, *_ in want.values():
        module = importlib.import_module(
            f"multigridcmt_tpu_torch.kernels.{mod}")
        assert getattr(module, counter) == 0
        assert (ROOT / source).is_file()


def test_chip_smoke_lists_the_native_bf16_modes():
    """The native bfloat16 modes of slice B1, each launched once by its
    direct run: the stencil2d and local2d residuals and sweeps (from
    csrc/native_bf16.cu; a whole grid's RB-GS and Jacobi sweeps from the row
    stream's csrc/stencil2d_sweep_native_bf16.cu and
    stencil2d_jacobi_native_bf16.cu) and the DIA SpMV (csrc/spmv.cu), each
    with its TPU function, counted apart from its float twin."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    src = "multigridcmt_tpu_torch/kernels/csrc/"
    tpu = "multigridcmt_tpu/kernels/"
    want = {
        f"{mod}_{mode}_bf16": (mod, f"{mode}_bf16_launches",
                               src + "native_bf16.cu", f"{tpu}{mod}.py:{line}",
                               None)
        for mod, lines in (("stencil2d", (304, 284, 295)),
                           ("local2d", (289, 263, 278)))
        for mode, line in zip(("residual", "rbgs", "jacobi"), lines)}
    want["stencil2d_rbgs_bf16"] = ("stencil2d", "rbgs_bf16_launches",
                                   src + "stencil2d_sweep_native_bf16.cu",
                                   tpu + "stencil2d.py:284", None)
    want["stencil2d_jacobi_bf16"] = ("stencil2d", "jacobi_bf16_launches",
                                     src + "stencil2d_jacobi_native_bf16.cu",
                                     tpu + "stencil2d.py:295", None)
    want["spmv_dia_bf16"] = ("spmv", "bf16_launches", src + "spmv.cu",
                             tpu + "spmv.py:254", None)
    assert {name: smoke.KERNELS[name] for name in want} == want
    assert {smoke.DIRECT_RUNS[name] for name in want} == {
        "native_bf16_direct"}
    for mod, counter, source, *_ in want.values():
        module = importlib.import_module(
            f"multigridcmt_tpu_torch.kernels.{mod}")
        assert getattr(module, counter) == 0
        assert (ROOT / source).is_file()


def test_chip_smoke_lists_the_native_b2_modes():
    """The last native bfloat16 modes (the fused2d legs and the transfer2d
    residual restriction, from the row stream's native sources, and the
    prolongation-add, from its block kernel's
    csrc/transfer2d_prolong_native_bf16.cu), each with its TPU function and
    a counter of its own, run on the bfloat16 solves of phase 3, which are
    main-path runs (their launches summed over MAIN_RUNS)."""
    csrc = "multigridcmt_tpu_torch/kernels/csrc/"
    tpu = "multigridcmt_tpu/kernels/"
    want = {
        "fused2d_down_bf16": ("fused2d", "down_bf16_launches",
                              csrc + "fused2d_native_bf16.cu",
                              tpu + "fused2d.py:289", None),
        "fused2d_up_bf16": ("fused2d", "up_bf16_launches",
                            csrc + "fused2d_up_native_bf16.cu",
                            tpu + "fused2d.py:479", None),
        "transfer2d_residual_restrict_bf16": (
            "transfer2d", "residual_restrict_bf16_launches",
            csrc + "transfer2d_native_bf16.cu", tpu + "transfer2d.py:371",
            None),
        "transfer2d_prolong_add_bf16": (
            "transfer2d", "prolong_add_bf16_launches",
            csrc + "transfer2d_prolong_native_bf16.cu",
            tpu + "transfer2d.py:204", None)}
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {name: smoke.KERNELS[name] for name in want} == want
    assert not set(want) & set(smoke.DIRECT_RUNS)
    assert set(smoke.BF16_SOLVES) <= set(smoke.MAIN_RUNS)
    for mod, counter, source, *_ in want.values():
        module = importlib.import_module(
            f"multigridcmt_tpu_torch.kernels.{mod}")
        assert getattr(module, counter) == 0
        assert (ROOT / source).is_file()


def test_chip_smoke_lists_the_stencil3d_bf16_modes():
    """The stencil3d kernels' bfloat16 modes, all built from
    csrc/stencil3d_bf16.cu: the residual and the bfloat16-storing RB-GS
    sweep on the mixed3d path, the bfloat16-storing Jacobi sweep on the
    sharded mixed Jacobi slab path (the single-device 3D Jacobi cycle runs
    plain), the float32-storing sweeps by direct calls (every mixed 3D
    cycle promotes its fine level at the correction add)."""
    rows = {name: row for name, row in _chip_smoke_rows("stencil3d").items()
            if "bf16" in name}
    src = "multigridcmt_tpu_torch/kernels/csrc/stencil3d_bf16.cu"
    tpu = "multigridcmt_tpu/kernels/stencil3d.py:"
    assert {name: row[1:] for name, row in rows.items()} == {
        "stencil3d_residual_bf16": ("residual_bf16_launches", src,
                                    tpu + "474", "mixed3d"),
        "stencil3d_rbgs_bf16": ("rbgs_bf16_launches", src, tpu + "510",
                                "mixed3d"),
        "stencil3d_rbgs_bf16_f32": ("rbgs_bf16_f32_launches", src,
                                    tpu + "510", None),
        "stencil3d_jacobi_bf16": ("jacobi_bf16_launches", src, tpu + "485",
                                  "slab511-mixed-jacobi"),
        "stencil3d_jacobi_bf16_f32": ("jacobi_bf16_f32_launches", src,
                                      tpu + "485", None)}
    for row in rows.values():
        assert hasattr(stencil3d, row[1]) and (ROOT / row[2]).is_file()
