"""Time variants of the BELL SpMM kernel (csrc/bell.cu) on one CUDA card.

    python -m multigridcmt_tpu_torch.utils.bell_variants \\
        [NAME="OLD=>NEW||OLD=>NEW" ...] [NAME=@path/to/source.cu ...]

Each variant is csrc/bell.cu with its substitutions made: ``OLD`` a
constant's name (``kStages``: its value becomes NEW) or any text of the
source (every occurrence becomes NEW), or the source at a path; the
source as it is runs as "shipped". Each variant is compiled with the library's nvcc flags into a
library of its own (all at once; ptxas's registers and spills of each
kernel instance are printed), held against ``bell.spmm_plain`` on the
SpMV bench's matrix (64 x 64 blocks of 128^2, density 0.15, seed 1) at
m = 128, 8, 16 and 40, with NaN and Inf in Xt's first block column and
with the stored blocks of each block row reversed, in float32 and
float64, and then timed in turns (the variants in order, then in reverse)
by the profiler's device time a call: the bench matrix at m = 128 and
m = 8, and a BELL of the same shape with every stored block populated
(the FMA rate with no padding and no imbalance), beside the card's SM
clock and power draw.

Informative only: nothing is checked but the comparisons. Needs nvcc and
a CUDA device.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from multigridcmt_tpu_torch.kernels import _build, bell
from multigridcmt_tpu_torch.utils.breakdown import bell_bench, device_busy

PTXAS = re.compile(r"Function properties for \S*bell_spmm_kernelI([fd])Li(\d+)E")


def variant_source(src: str, subs: dict) -> str:
    for old, new in subs.items():
        src, n = re.subn(rf"constexpr int {re.escape(old)} = \d+;",
                         lambda _: f"constexpr int {old} = {new};", src)
        if not n:
            src, n = re.subn(re.escape(old), lambda _: new, src)
        if not n:
            raise ValueError(f"{old!r} is not in csrc/bell.cu")
    return src


def build(name: str, src: str, out: Path):
    """(library path, ptxas summary) of one variant."""
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                           "-Xptxas", "-v", "-shared", "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-4000:]}")
    summary, key, spill = [], None, 0
    for line in (proc.stdout + proc.stderr).splitlines():
        m = PTXAS.search(line)
        if m:
            key = f"{m.group(1)}{m.group(2)}"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and key:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            summary.append(f"{key}:{m.group(1)}r"
                           + (f"/spill{spill}" if spill else ""))
            key = None
    return so, " ".join(summary)


def load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    for t in ("f32", "f64"):
        fn = getattr(lib, f"mg_bell_spmm_{t}")
        fn.argtypes = _build.SIGNATURES[f"mg_bell_spmm_{t}"]
        fn.restype = ctypes.c_int
    return lib


def call(lib, a: bell.BELL, xt: torch.Tensor) -> torch.Tensor:
    yt = torch.empty((xt.shape[0], a.nbr * bell.BM), dtype=xt.dtype,
                     device=xt.device)
    t = "f32" if xt.dtype == torch.float32 else "f64"
    status = getattr(lib, f"mg_bell_spmm_{t}")(
        a.data.data_ptr(), a.cols.data_ptr(), xt.data_ptr(), yt.data_ptr(),
        a.nbr, a.kmax, xt.shape[0], xt.shape[1],
        torch.cuda.current_stream().cuda_stream)
    if status:
        raise RuntimeError(f"launch failed: CUDA error {status}")
    return yt


def compare(lib, a, xt, tol) -> str | None:
    """None if the kernel matches the plain version (non-finite values
    where the plain version has them, a second call bit for bit), else a
    description."""
    got, again = call(lib, a, xt), call(lib, a, xt)
    want = bell.spmm_plain(a, xt)
    fin = want.isfinite()
    err = ((got - want)[fin].abs().max() / want[fin].abs().max()).item()
    if not (torch.equal(got.isnan(), want.isnan())
            and torch.equal(got.isinf(), want.isinf())):
        return "non-finite values elsewhere than plain's"
    if not torch.equal(got.nan_to_num(), again.nan_to_num()):
        return "a second call differs"
    return None if err <= tol else f"rel {err:.3e} > {tol}"


def check(lib) -> list:
    fails = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        a, xt = bell_bench(dtype)
        xn = xt.clone()
        xn[3, 5], xn[70, 100], xn[9, 130] = (float("nan"), float("inf"),
                                             float("nan"))
        rev = bell.BELL(data=a.data.flip(1).contiguous(),
                        cols=a.cols.flip(1).contiguous(), shape=a.shape,
                        nnz_scalar=a.nnz_scalar)
        for label, aa, x in (
                [(f"m={m}", a, xt[:m].contiguous()) for m in (128, 8, 16, 40)]
                + [(f"nan/inf m={m}", a, xn[:m].contiguous()) for m in (128, 8)]
                + [(f"reversed m={m}", rev, xn[:m].contiguous())
                   for m in (128, 8)]):
            why = compare(lib, aa, x, tol)
            if why:
                fails.append(f"{dtype} {label}: {why}")
    return fails


def main() -> None:
    src = (_build.CSRC / "bell.cu").read_text()
    variants = {"shipped": src}
    for arg in sys.argv[1:]:
        name, subs = arg.split("=", 1)
        variants[name] = (Path(subs[1:]).read_text() if subs.startswith("@")
                          else variant_source(src, dict(
                              s.split("=>", 1) for s in subs.split("||"))))
    smi = lambda q: subprocess.run(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi("name,power.limit"), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(variants)) as ex:
            built = dict(zip(variants, ex.map(
                lambda kv: build(kv[0], kv[1], Path(tmp)),
                variants.items())))
        print(f"built {len(built)} variants in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        libs = {}
        for name, (so, summary) in built.items():
            lib = load(so)
            try:
                fails = check(lib)
            except RuntimeError as exc:        # a launch the card refuses
                print(f"{name}: ptxas {summary}; {exc}; dropped", flush=True)
                continue
            libs[name] = lib
            print(f"{name}: ptxas {summary}; "
                  + ("matches plain" if not fails else "FAILS " + "; ".join(
                      fails)), flush=True)
        a, xt = bell_bench()
        x8 = xt[:8].contiguous()
        dense = bell.BELL(data=torch.randn_like(a.data), cols=a.cols,
                          shape=a.shape, nnz_scalar=a.nnz_scalar)
        flops = 2 * dense.data.numel() * xt.shape[0]
        order = list(libs)
        for name in order + order[::-1]:
            lib = libs[name]
            t128 = device_busy(lambda: call(lib, a, xt), 20)[0]
            t8 = device_busy(lambda: call(lib, a, x8), 20)[0]
            td = device_busy(lambda: call(lib, dense, xt), 20)[0]
            print(f"{name}: device ms a call, m=128 {t128:.4f}, m=8 "
                  f"{t8:.4f}, every block populated m=128 {td:.4f} "
                  f"({flops / td / 1e9:.1f} TFLOP/s); "
                  f"{smi('clocks.sm,power.draw')}", flush=True)


if __name__ == "__main__":
    main()
