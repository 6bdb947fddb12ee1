"""Build and load the CUDA kernel library.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library goes to
``kernels/build/<hash of the sources>/``, so an edited source builds anew
and an unchanged one is built once per checkout. Nothing here runs at
import time: the first kernel launch builds the library.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"
LIB_NAME = "libmgkernels.so"
LOG_NAME = "nvcc.log"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)

# C entry points: name -> argument types. Each returns cudaGetLastError()
# after its launch. Pointer and stream arguments are c_void_p so ctypes
# passes them as 64-bit values.
SIGNATURES = {}
for _t in ("f32", "f64"):
    # u, b, r, n, h, sigma, stream
    SIGNATURES[f"mg_stencil2d_residual_{_t}"] = [_P, _P, _P, _I, _D, _D, _P]
    # u, b, out, n, h, sigma, kind, omega, sweeps, geometry
    # (packed2d.LegGeometry.ints() of the sweep stream on the unpacked
    # frame), stream
    SIGNATURES[f"mg_stencil2d_sweep_{_t}"] = [_P, _P, _P, _I, _D, _D, _I, _D,
                                              _I, _IP, _P]
    # u, b, rc_out, n, h, geometry (packed2d.LegGeometry.ints() of the
    # zero-sweep down leg on the unpacked frame), stream
    SIGNATURES[f"mg_transfer2d_residual_restrict_{_t}"] = [_P, _P, _P, _I,
                                                           _D, _IP, _P]
    # x, e, out, n, stream
    SIGNATURES[f"mg_transfer2d_prolong_add_{_t}"] = [_P, _P, _P, _I, _P]
    # u, b, u_out, rc_out, n, h, sigma, kind, omega, sweeps, geometry
    # (packed2d.LegGeometry.ints() on the unpacked frame), stream
    SIGNATURES[f"mg_fused2d_down_{_t}"] = [_P, _P, _P, _P, _I, _D, _D, _I,
                                           _D, _I, _IP, _P]
    # x, e, b, out, n, h, sigma, kind, omega, sweeps, geometry, stream
    SIGNATURES[f"mg_fused2d_up_{_t}"] = [_P, _P, _P, _P, _I, _D, _D, _I, _D,
                                         _I, _IP, _P]
    # u, b, u_out, rc_out, n, h, sigma, kind, omega, sweeps, packed_coarse,
    # geometry (packed2d.LegGeometry.ints()), stream
    SIGNATURES[f"mg_packed2d_down_{_t}"] = [_P, _P, _P, _P, _I, _D, _D, _I,
                                            _D, _I, _I, _IP, _P]
    # x, e, b, out, n, h, sigma, kind, omega, sweeps, packed_e, geometry,
    # stream
    SIGNATURES[f"mg_packed2d_up_{_t}"] = [_P, _P, _P, _P, _I, _D, _D, _I, _D,
                                          _I, _I, _IP, _P]
    # u, b, partial, out, n, h, sigma, red_only, blocks, stream
    SIGNATURES[f"mg_packed2d_resnorm_{_t}"] = [_P, _P, _P, _P, _I, _D, _D, _I,
                                               _I, _P]
    # u, b, r, n, h, sigma, stream
    SIGNATURES[f"mg_packed2d_residual_{_t}"] = [_P, _P, _P, _I, _D, _D, _P]
    # u, b, out, n, h, sigma, sweeps, geometry (packed2d.LegGeometry.ints()
    # of the sweep stream), stream
    SIGNATURES[f"mg_packed2d_rbgs_{_t}"] = [_P, _P, _P, _I, _D, _D, _I, _IP,
                                            _P]
    # u, b, out, p, r, c, n, h, sigma, goff, roff, geometry
    # (stencil3d.march_geometry), stream
    SIGNATURES[f"mg_stencil3d_residual_{_t}"] = [_P, _P, _P, _I, _I, _I, _I,
                                                 _D, _D, _I, _I, _IP, _P]
    # u, b, out, p, r, c, n, h, sigma, omega, goff, roff, geometry, stream
    SIGNATURES[f"mg_stencil3d_jacobi_{_t}"] = [_P, _P, _P, _I, _I, _I, _I, _D,
                                               _D, _D, _I, _I, _IP, _P]
    # u, b, out, p, r, c, n, h, sigma, goff, roff, geometry, stream
    SIGNATURES[f"mg_stencil3d_rbgs_{_t}"] = [_P, _P, _P, _I, _I, _I, _I, _D,
                                             _D, _I, _I, _IP, _P]
    # diags, x, offsets, y, ndiag, len = R*128, skirt = H*128, stream
    SIGNATURES[f"mg_spmv_dia_{_t}"] = [_P, _P, _P, _P, _I, _L, _L, _P]
    # data, cols, xt, yt, nbr, kmax, m, ldx, stream
    SIGNATURES[f"mg_bell_spmm_{_t}"] = [_P, _P, _P, _P, _L, _L, _L, _L, _P]
    # u, b, out, R, C, n, row_off, col_off, h, sigma, kind, omega, sweeps,
    # geometry (local2d.leg_geometry of the sweep stream), stream
    SIGNATURES[f"mg_local2d_sweep_{_t}"] = [_P, _P, _P, _I, _I, _I, _I, _I, _D,
                                            _D, _I, _D, _I, _IP, _P]
    # u, b, r, R, C, n, row_off, col_off, h, sigma, stream
    SIGNATURES[f"mg_local2d_residual_{_t}"] = [_P, _P, _P] + [_I] * 5 + [
        _D, _D, _P]
    # u, b, u_out, rc, R, C, Rc, Cc, n, row_off, col_off, crow, ccol, qlo,
    # qhi, slo, shi, h, sigma, kind, omega, sweeps, geometry
    # (local2d.leg_geometry), stream
    SIGNATURES[f"mg_local2d_down_{_t}"] = [_P, _P, _P, _P] + [_I] * 13 + [
        _D, _D, _I, _D, _I, _IP, _P]
    # x, e, b, out, R, C, Rc, Cc, n, row_off, col_off, crow, ccol, h, sigma,
    # kind, omega, sweeps, geometry, stream
    SIGNATURES[f"mg_local2d_up_{_t}"] = [_P, _P, _P, _P] + [_I] * 9 + [
        _D, _D, _I, _D, _I, _IP, _P]
    # u, b, out, R, C, n, row_off, col_off, h, sigma, has_b, stream
    SIGNATURES[f"mg_plocal2d_residual_{_t}"] = [_P, _P, _P] + [_I] * 5 + [
        _D, _D, _I, _P]
    # The packed tile's legs take local2d's arguments (R, C: the unpacked
    # tile's extent), their geometry from plocal2d.leg_geometry.
    for _leg in ("down", "up"):
        SIGNATURES[f"mg_plocal2d_{_leg}_{_t}"] = SIGNATURES[
            f"mg_local2d_{_leg}_{_t}"]
    # u, b, partial, out, R, C, n, row_off, col_off, qlo, qhi, slo, shi, h,
    # sigma, red_only, blocks, stream
    SIGNATURES[f"mg_plocal2d_resnorm_{_t}"] = [_P, _P, _P, _P] + [_I] * 9 + [
        _D, _D, _I, _I, _P]

# The bfloat16 storage modes (the packed fine level of a mixed cycle, in
# csrc/packed2d_bf16.cu, packed2d_sweep_bf16.cu, packed2d_up_bf16.cu and
# packed2d_up_bf16_f32.cu): the float32 entry points' arguments; the coarse
# operand (rc, e) is float32. mg_packed2d_up_bf16_f32 stores x' in float32.
for _name in ("packed2d_down", "packed2d_up", "packed2d_residual",
              "packed2d_rbgs"):
    SIGNATURES[f"mg_{_name}_bf16"] = SIGNATURES[f"mg_{_name}_f32"]
SIGNATURES["mg_packed2d_up_bf16_f32"] = SIGNATURES["mg_packed2d_up_f32"]
# The shard tile legs' bfloat16 storage modes (the fine level of a sharded
# mixed cycle, csrc/local2d_legs_bf16.cu, local2d_up_bf16_f32.cu,
# plocal2d_legs_bf16.cu and plocal2d_up_bf16_f32.cu), with the same rule.
for _name in ("local2d_down", "local2d_up", "plocal2d_down", "plocal2d_up"):
    SIGNATURES[f"mg_{_name}_bf16"] = SIGNATURES[f"mg_{_name}_f32"]
for _name in ("local2d_up", "plocal2d_up"):
    SIGNATURES[f"mg_{_name}_bf16_f32"] = SIGNATURES[f"mg_{_name}_f32"]
# The bfloat16 storage modes of the whole grid's and the packed tile's
# residual norm (out float32), the packed tile's residual and apply
# (csrc/packed2d_bf16.cu, plocal2d_bf16.cu) and the BELL SpMM (csrc/bell.cu,
# a float32 accumulator): the float32 entry points' arguments.
for _name in ("packed2d_resnorm", "plocal2d_residual", "plocal2d_resnorm",
              "bell_spmm"):
    SIGNATURES[f"mg_{_name}_bf16"] = SIGNATURES[f"mg_{_name}_f32"]
# The stencil3d kernels' bfloat16 storage modes (the fine level of a mixed
# 3D cycle, csrc/stencil3d_bf16.cu): the float32 entry points' arguments.
# The residual stores r in float32; the sweeps' _bf16_f32 entry points store
# their output in float32 (out_dtype).
for _name in ("stencil3d_residual", "stencil3d_jacobi", "stencil3d_rbgs"):
    SIGNATURES[f"mg_{_name}_bf16"] = SIGNATURES[f"mg_{_name}_f32"]
for _name in ("stencil3d_jacobi", "stencil3d_rbgs"):
    SIGNATURES[f"mg_{_name}_bf16_f32"] = SIGNATURES[f"mg_{_name}_f32"]
# The native bfloat16 modes (every operation rounded to bfloat16, the
# constants rounded on the host; csrc/native_bf16.cu and spmv.cu): u, b, r,
# R, C, n, row_off, col_off, inv_h2, sigma, stream; u, b, out, tmp, R, C,
# n, row_off, col_off, h2, inv_h2, sigma, inv_den, coef, kind, sweeps,
# stream; the DIA SpMV with the float32 entry point's arguments.
SIGNATURES["mg_native2d_residual_bf16"] = [_P, _P, _P] + [_I] * 5 + [
    _D, _D, _P]
SIGNATURES["mg_native2d_sweep_bf16"] = [_P] * 4 + [_I] * 5 + [_D] * 5 + [
    _I, _I, _P]
SIGNATURES["mg_spmv_dia_bf16"] = SIGNATURES["mg_spmv_dia_f32"]
# The native residual restriction of transfer2d (the row stream,
# csrc/transfer2d_native_bf16.cu): u, b, rc, n, inv_h2, geometry (the
# zero-sweep fused2d.leg_geometry("down", ...)), stream; its
# prolongation-add (csrc/transfer2d_prolong_native_bf16.cu): x, e, out, n,
# stream.
SIGNATURES["mg_native2d_residual_restrict_bf16"] = [_P, _P, _P, _I, _D, _IP,
                                                    _P]
SIGNATURES["mg_transfer2d_prolong_add_native_bf16"] = [_P, _P, _P, _I, _P]
# The native fused2d legs (the row stream, csrc/fused2d_native_bf16.cu and
# fused2d_up_native_bf16.cu): u, b, u_out, rc, n, h2, inv_h2, sigma,
# inv_den, coef (native_bf16.constants), kind, sweeps, geometry
# (fused2d.leg_geometry), stream; x, e, b, out and the rest as the down
# leg's.
SIGNATURES["mg_fused2d_down_native_bf16"] = [_P] * 4 + [_I] + [_D] * 5 + [
    _I, _I, _IP, _P]
SIGNATURES["mg_fused2d_up_native_bf16"] = SIGNATURES[
    "mg_fused2d_down_native_bf16"]
# The native RB-GS and Jacobi sweeps of a whole grid (the row stream,
# csrc/stencil2d_sweep_native_bf16.cu and stencil2d_jacobi_native_bf16.cu):
# u, b, out, n, h2, inv_h2, sigma, inv_den, coef, sweeps, geometry
# (fused2d.leg_geometry("sweep", ...)), stream.
SIGNATURES["mg_stencil2d_sweep_native_bf16"] = [_P] * 3 + [_I] + [_D] * 5 + [
    _I, _IP, _P]
SIGNATURES["mg_stencil2d_jacobi_native_bf16"] = SIGNATURES[
    "mg_stencil2d_sweep_native_bf16"]

# Kind codes shared with csrc/common.cuh.
KIND_CODES = {"jacobi": 0, "rbgs": 1}

# The halo a launch loads grows with its sweeps (RB-GS makes 2 rings stale
# a sweep, Jacobi 1; a down leg adds 2 for the residual and the
# restriction). Capping it at 8, as the TPU kernels do, bounds the rows a
# row-streaming lane holds and makes the same legs and sweep chunks fuse as
# in the JAX package; it bounds the sweeps of every 2D launch.
MAX_HALO = 8


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    digest = hashlib.sha256()
    for path in sources():
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = cuda_home / "bin" / "nvcc"
    return str(candidate) if candidate.is_file() else None


def _check_nvcc(cmd, returncode: int, out: str, err: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n"
                           f"{out}\n{err}")


def build_library(out_dir: Path) -> Path:
    """Compile every ``csrc/*.cu`` into ``out_dir/libmgkernels.so`` unless
    it is there already; return the library's path. What ptxas says of
    each kernel (registers, spills, shared memory) goes to
    ``out_dir/nvcc.log``."""
    lib = Path(out_dir) / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
            "/usr/local/cuda/bin): the CUDA kernels of multigridcmt_tpu_torch "
            "are compiled at first use and need the CUDA toolkit")
    lib.parent.mkdir(parents=True, exist_ok=True)
    # Build under temporary names and rename, so a concurrent process never
    # loads a half-written library.
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs, procs = [], []
        for cu in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, cu.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                   str(cu)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        # Wait for every compile before reporting the first failure.
        done = [(cmd, *proc.communicate(), proc.returncode)
                for cmd, proc in procs]
        for cmd, out, err, returncode in done:
            _check_nvcc(cmd, returncode, out, err)
        Path(out_dir, LOG_NAME).write_text("".join(
            f"$ {' '.join(cmd)}\n{out}{err}" for cmd, out, err, _ in done))
        so = os.path.join(tmp, LIB_NAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check_nvcc(cmd, proc.returncode, proc.stdout, proc.stderr)
        os.replace(so, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = ctypes.CDLL(str(build_library(BUILD_ROOT / source_hash())))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mg_error_string.argtypes = [ctypes.c_int]
    lib.mg_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call the C entry point ``name``; raise if it reports a CUDA error."""
    lib = load_library()
    status = getattr(lib, name)(*args)
    if status != 0:
        raise RuntimeError(f"{name} failed: CUDA error {status} "
                           f"({lib.mg_error_string(status).decode()})")
