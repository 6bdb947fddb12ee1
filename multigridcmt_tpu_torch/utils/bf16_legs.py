"""Hold the row stream's bfloat16 legs and sweep against other trees'
builds, bit for bit, and time them in turns, on one CUDA card.

    python -m multigridcmt_tpu_torch.utils.bf16_legs OTHER [OTHER ...] \\
        [--json PATH] [--sass REGEX --sass-dir DIR]

Each OTHER is the root of another checkout of the repository (the parent
commit unpacked with ``git archive`` into the git-ignored
``.chip_scratch/``, or a variant of this tree). Its bfloat16 leg and sweep
sources (BF16_SOURCES) and, for the first OTHER only, its full-precision
leg and sweep sources (FULL_SOURCES) are compiled, each by its own nvcc
with the library's flags and ``-Xptxas -v``, all at once and beside this
tree's own build, and linked into a library of its own (each library is
loaded apart, so the entry points keep their names). Then:

1. ptxas: the registers and spill bytes of every float32 and float64
   row-stream kernel (the legs, sweeps and the residual-restriction
   stream, by mangled name after the namespace) of this build against the
   first OTHER's; the bfloat16 kernels' lines of every library side by
   side.
2. Bits: every bfloat16 entry point of the row stream (MODES) on the same
   inputs in each library, its outputs compared bit for bit, at every case
   of CASES (sigma 0 and 11.5; nu 0, 1, 2 and 3; RB-GS and Jacobi; the up
   legs storing bfloat16 and float32; packed and logical coarse grids):
   4095^2 packed, and S1's fine tile (config 5's 4095^2 on a row mesh of
   one) unpacked (local2d) and packed (plocal2d).
3. Times, at RB-GS nu = 2 (the sweep nu = 4) and sigma 0 as the mixed
   paths run them: each mode in each library and its float32 twin (the
   same entry point's float32 form in this library, on the widened
   inputs), in turns (the libraries in order, then in reverse): chained
   (LEG_CHAIN calls between one pair of CUDA events, median of 5) and the
   profiler's device time a call; beside the mode's bound (its inputs read
   once and outputs written once at 3.35 TB/s). The float32 packed2d legs
   at 4095^2 and fused2d legs at 2047^2 (the main path's) are timed from
   this library and the first OTHER's the same way.

Every call is replayed through ctypes with the arguments the port's
wrapper passed (captured once), so each library's kernel sees the same
geometry and inputs and the same host path. Prints the card's name and
power limit, a line for each finding and one JSON object last; exits 1 if
a bit differs or a float32/float64 kernel's ptxas line differs. Needs nvcc
and a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from multigridcmt_tpu_torch.kernels import (_build, fused2d, local2d,
                                            packed2d, plocal2d)
from multigridcmt_tpu_torch.utils.breakdown import device_busy
from multigridcmt_tpu_torch.utils.profiling import chained_ms

BF16_SOURCES = ("packed2d_bf16.cu", "packed2d_up_bf16.cu",
                "packed2d_up_bf16_f32.cu", "packed2d_sweep_bf16.cu",
                "local2d_legs_bf16.cu", "local2d_up_bf16_f32.cu",
                "plocal2d_legs_bf16.cu", "plocal2d_up_bf16_f32.cu")
FULL_SOURCES = ("packed2d.cu", "packed2d_up.cu", "packed2d_up_f64.cu",
                "packed2d_sweep.cu", "plocal2d_legs.cu",
                "plocal2d_legs_f64.cu", "local2d_legs.cu",
                "local2d_legs_f64.cu", "local2d_sweep.cu",
                "local2d_sweep_f64.cu", "fused2d.cu", "fused2d_up.cu",
                "fused2d_up_f64.cu", "stencil2d_sweep.cu",
                "stencil2d_sweep_f64.cu", "transfer2d.cu")
STREAM_KERNEL = re.compile(
    r"(down|up|sweep|residual_restrict)_kernelI\w*")
PEAK_BYTES_PER_S = 3.35e12
LEG_CHAIN = 20
N = 4095
SIGMA = 11.5
BF, F32 = torch.bfloat16, torch.float32
# (kind, sweeps, sigma) of the bit comparisons: mixedA's zero-sweep legs,
# the mixed paths' nu = 2, odd stage counts and Jacobi.
CASES = (("rbgs", 0, SIGMA), ("rbgs", 0, 0.0), ("rbgs", 1, SIGMA),
         ("rbgs", 2, 0.0), ("rbgs", 2, SIGMA), ("jacobi", 2, SIGMA),
         ("jacobi", 3, 0.0))
SWEEP_CASES = ((1, SIGMA), (2, 0.0), (4, 0.0), (4, SIGMA))
# The ten timed rows: name -> (module, leg, out_dtype).
MODES = {
    "packed2d_down_bf16": ("packed2d", "down", None),
    "packed2d_up_bf16_f32": ("packed2d", "up", F32),
    "packed2d_up_bf16": ("packed2d", "up", None),
    "local2d_down_bf16": ("local2d", "down", None),
    "local2d_up_bf16_f32": ("local2d", "up", F32),
    "local2d_up_bf16": ("local2d", "up", None),
    "plocal2d_down_bf16": ("plocal2d", "down", None),
    "plocal2d_up_bf16_f32": ("plocal2d", "up", F32),
    "plocal2d_up_bf16": ("plocal2d", "up", None),
    "packed2d_rbgs_bf16": ("packed2d", "sweep", None),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_props(text: str) -> dict:
    """{mangled name from the stream kernel's own name on: (registers,
    spill bytes)} of the row-stream kernels in ptxas's -v output."""
    props, name, spill = {}, None, 0
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = STREAM_KERNEL.search(m.group(1))
            name, spill = (m.group(1)[k.start():] if k else None), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            props[name] = (int(m.group(1)), spill)
            name = None
    return props


def start_build(root: Path, out: Path, full: bool,
                sources: tuple | None = None) -> list:
    """Start an nvcc for each of root's BF16_SOURCES (and, with ``full``,
    FULL_SOURCES), or for each of ``sources``."""
    csrc = root / "multigridcmt_tpu_torch" / "kernels" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    if sources is None:
        sources = BF16_SOURCES + (FULL_SOURCES if full else ())
    for name in sources:
        obj = out / (Path(name).stem + ".o")
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-c", "-o", str(obj), str(csrc / name)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
    return procs


def finish_build(procs: list, out: Path) -> tuple:
    """(loaded library, ptxas text) of a started build."""
    text = []
    for obj, proc in procs:
        o, e = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {obj.stem}.cu\n{e[-4000:]}")
        text.append(o + e)
    so = out / "lib.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
           *(str(obj) for obj, _ in procs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"link failed\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib, "".join(text)


@contextlib.contextmanager
def captured():
    """The (entry point, arguments) of every launch made inside."""
    calls, orig = [], _build.launch

    def launch(name, *args):
        calls.append((name, args))
        orig(name, *args)

    _build.launch = launch
    try:
        yield calls
    finally:
        _build.launch = orig


class Call:
    """One captured launch, replayable in any library, with its outputs
    fresh (NaN-filled, so an entry no kernel writes compares equal and one
    only a kernel writes cannot match by chance)."""

    def __init__(self, run, inputs):
        with captured() as calls:
            result = run()
        torch.cuda.synchronize()
        (self.name, self.args), = calls
        result = result if isinstance(result, tuple) else (result,)
        self.outs = list(result)
        self.ptrs = [t.data_ptr() for t in self.outs]
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in list(inputs) + self.outs)
        self.keep = (run, inputs)    # the tensors the arguments point to

    def replay(self, lib):
        outs = [torch.full_like(t, float("nan")) for t in self.outs]
        swap = dict(zip(self.ptrs, (t.data_ptr() for t in outs)))
        args = [swap.get(a, a) if isinstance(a, int) else a
                for a in self.args]
        status = getattr(lib, self.name)(*args)
        if status:
            raise RuntimeError(f"{self.name}: CUDA error {status}")
        return outs

    def fn(self, lib):
        f = getattr(lib, self.name)
        args = self.args
        return lambda: f(*args)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def inputs():
    """bfloat16 u, b (b of 1/h^2 size) and a float32 e: the packed 4095^2
    grid (e logical and packed) and S1's fine tile, unpacked and packed
    (e in the extended convention)."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    n, nc, hh = N, (N - 1) // 2, local2d.HALO_ROWS

    def normal(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    u, b = (torch.zeros((n + 2, n + 2), device="cuda") for _ in range(2))
    u[1:-1, 1:-1] = normal((n, n))
    b[1:-1, 1:-1] = normal((n, n), float((n + 1) ** 2))
    e = torch.zeros((nc + 2, nc + 2), device="cuda")
    e[1:-1, 1:-1] = normal((nc, nc))
    whole = dict(u=packed2d.pack(u).to(BF), b=packed2d.pack(b).to(BF), e=e,
                 pe=packed2d.pack(e))
    # S1's tile: rows [1 - hh, n + 1 + hh) of the grid, all its columns.
    rows = n + 1 + 2 * hh

    def tile(g):
        t = torch.zeros((rows, n + 2), device="cuda")
        t[hh - 1:hh + n + 1] = g
        return t.to(BF)

    ue, be = tile(u), tile(b)
    ee = normal(((n + 1) // 2 + 2 * hh, nc + 2))
    return whole, dict(u=ue, b=be, e=ee), dict(
        u=plocal2d.pack_ext(ue, 0), b=plocal2d.pack_ext(be, 0), e=ee)


def launcher(mod: str, leg: str, data: dict, kind: str, sweeps: int,
             sigma: float, out_dtype=None, packed: bool = False,
             dtype=BF):
    """(run, inputs) of one launch of ``mod``'s ``leg`` through the port's
    wrapper, its fine inputs in ``dtype``."""
    n, nc, h = N, (N - 1) // 2, 1.0 / (N + 1)
    u, b = data["u"].to(dtype), data["b"].to(dtype)
    kw = dict(kind=kind, omega=1.0 if kind == "rbgs" else 0.8, sweeps=sweeps,
              sigma=sigma)
    if mod == "packed2d":
        e = data["pe"] if packed else data["e"]
        if leg == "down":
            return (lambda: packed2d.smooth_residual_restrict(
                u, b, n, h, packed_coarse=packed, **kw)), (u, b)
        if leg == "up":
            return (lambda: packed2d.prolong_add_smooth(
                u, e, b, n, nc, h, out_dtype=out_dtype, **kw)), (u, e, b)
        return (lambda: packed2d.rbgs_sweep(u, b, n, h, sweeps=sweeps,
                                            sigma=sigma)), (u, b)
    m, offs = N + 1, (1 - local2d.HALO_ROWS, 0)
    lm = local2d if mod == "local2d" else plocal2d
    if leg == "down":
        return (lambda: lm.down_leg(u, b, n, h, m, *offs, **kw)), (u, b)
    e = data["e"]
    return (lambda: lm.up_leg(u, e, b, n, nc, h, m, *offs,
                              out_dtype=out_dtype, **kw)), (u, e, b)


def compare_ptxas(mine: str, others: dict, first: str) -> tuple:
    """(failures, the bfloat16 kernels' lines) of the ptxas comparison:
    the float32/float64 kernels against ``first``'s."""
    fails, lines = [], {}
    own = ptxas_props(mine)
    for label, text in others.items():
        theirs = ptxas_props(text)
        full = ([k for k in theirs if "__nv_bfloat16" not in k]
                if label == first else [])
        missing = [k for k in full if k not in own]
        differ = [k for k in full if k in own and own[k] != theirs[k]]
        log(f"ptxas {label}: {len(full)} float32/float64 stream kernels, "
            f"{len(full) - len(missing) - len(differ)} equal, "
            f"{len(differ)} differ, {len(missing)} not in this build")
        for k in differ + missing:
            fails.append(f"ptxas {label} {k}: {theirs[k]} against "
                         f"{own.get(k)}")
        for k, v in theirs.items():
            if "__nv_bfloat16" in k:
                lines.setdefault(k, {})[label] = v
    for k in lines:
        lines[k]["this"] = own.get(k)
    return fails, lines


def dump_sass(libs: dict, pattern: str, out: Path) -> None:
    """cuobjdump's SASS of the kernels whose mangled name ``pattern``
    finds, a file for each library; ``libs``: label -> (library path,
    ptxas text naming its kernels)."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    out.mkdir(parents=True, exist_ok=True)
    for label, (so, text) in libs.items():
        names = sorted({m.group(1) for m in re.finditer(
            r"Function properties for (\S+)", text)
            if re.search(pattern, m.group(1))})
        sass = [subprocess.run([str(cuobjdump), "-sass", "-fun", name,
                                str(so)], capture_output=True,
                               text=True).stdout for name in names[:8]]
        (out / f"{label}.sass").write_text("\n".join(sass))
        log(f"sass {label}: {len(names[:8])} kernels to "
            f"{out / (label + '.sass')}")


def check_bits(libs: dict, data: dict) -> tuple:
    """(comparisons, failures) of every bfloat16 entry point at CASES (the
    sweep at SWEEP_CASES), each other library against this one."""
    calls = []
    for mod in ("packed2d", "local2d", "plocal2d"):
        for leg, out in (("down", None), ("up", None), ("up", F32)):
            for kind, nu, sigma in CASES:
                for packed in ((False, True) if mod == "packed2d" and nu == 1
                               else (False,)):
                    calls.append((f"{mod} {leg} out={out} {kind} nu={nu} "
                                  f"sigma={sigma} packed={packed}",
                                  (mod, leg, data[mod], kind, nu, sigma, out,
                                   packed)))
    for nu, sigma in SWEEP_CASES:
        calls.append((f"packed2d sweep nu={nu} sigma={sigma}",
                      ("packed2d", "sweep", data["packed2d"], "rbgs", nu,
                       sigma)))
    checks, fails = 0, []
    for what, args in calls:
        call = Call(*launcher(*args))
        ref = call.replay(libs["this"])
        for label, lib in libs.items():
            if label == "this":
                continue
            checks += 1
            if not all(torch.equal(bits(a), bits(b))
                       for a, b in zip(ref, call.replay(lib))):
                fails.append(f"bits {what}: {label} differs from this")
    torch.cuda.synchronize()
    return checks, fails


def in_turns(fns: dict) -> dict:
    """{label: [(chained ms, device ms), ...]} of each function, timed in
    order and then in reverse."""
    row = {}
    order = list(fns)
    for label in order + order[::-1]:
        fn = fns[label]
        row.setdefault(label, []).append(
            (chained_ms(fn, LEG_CHAIN), device_busy(fn, LEG_CHAIN)[0]))
    return row


def fmt(row: dict) -> str:
    return ", ".join(f"{k} " + "/".join(f"{c:.4f}c {d:.4f}d" for c, d in v)
                     for k, v in row.items() if k != "bound_ms")


def main_legs(whole: dict) -> dict:
    """The main path's float32 legs: packed2d at 4095^2, fused2d at
    2047^2, RB-GS nu = 2."""
    fu, fb = (whole[k].float() for k in ("u", "b"))
    n2 = 2047
    gen = torch.Generator(device="cuda").manual_seed(20)
    u2 = torch.zeros((n2 + 2, n2 + 2), device="cuda")
    b2 = torch.zeros_like(u2)
    u2[1:-1, 1:-1] = torch.randn((n2, n2), generator=gen, device="cuda")
    b2[1:-1, 1:-1] = torch.randn((n2, n2), generator=gen,
                                 device="cuda") * float((n2 + 1) ** 2)
    e2 = torch.zeros(((n2 - 1) // 2 + 2,) * 2, device="cuda")
    kw = dict(kind="rbgs", omega=1.0, sweeps=2)
    h, h2 = 1.0 / (N + 1), 1.0 / (n2 + 1)
    runs = {
        "packed2d_down_f32": lambda: packed2d.smooth_residual_restrict(
            fu, fb, N, h, **kw),
        "packed2d_up_f32": lambda: packed2d.prolong_add_smooth(
            fu, whole["e"], fb, N, (N - 1) // 2, h, **kw),
        "fused2d_down_f32@2047": lambda: fused2d.smooth_residual_restrict(
            u2, b2, n2, h2, **kw),
        "fused2d_up_f32@2047": lambda: fused2d.prolong_add_smooth(
            u2, e2, b2, n2, (n2 - 1) // 2, h2, **kw),
    }
    return {name: Call(run, (fu, fb, u2, b2)) for name, run in runs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", type=Path)
    ap.add_argument("--json", type=Path)
    ap.add_argument("--sass")
    ap.add_argument("--sass-dir", type=Path, default=Path("sass"))
    opt = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(smi)
    report = {"card": smi, "fails": []}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        labels = [p.name for p in opt.others]
        started = {label: start_build(root, Path(tmp) / label, k == 0)
                   for k, (label, root) in enumerate(zip(labels,
                                                         opt.others))}
        libs = {"this": _build.load_library()}
        texts = {}
        for label, procs in started.items():
            try:
                libs[label], texts[label] = finish_build(procs,
                                                         Path(tmp) / label)
            except RuntimeError as exc:
                if label == labels[0]:
                    raise
                log(f"{label}: dropped, {exc}")
        labels = [label for label in labels if label in libs]
        log(f"built this tree and {', '.join(labels)} in "
            f"{time.perf_counter() - t0:.1f} s")

        # 1. ptxas.
        mine_text = (_build.BUILD_ROOT / _build.source_hash()
                     / _build.LOG_NAME).read_text(errors="replace")
        fails, bf16_lines = compare_ptxas(mine_text, texts, labels[0])
        report["fails"] += fails
        report["ptxas_bf16"] = dict(sorted(bf16_lines.items()))
        for k, v in sorted(bf16_lines.items()):
            log(f"ptxas bf16 {k[:90]}: {v}")
        if opt.sass:
            sos = {"this": (_build.BUILD_ROOT / _build.source_hash()
                            / _build.LIB_NAME, mine_text)}
            sos.update({label: (Path(tmp) / label / "lib.so", texts[label])
                        for label in labels})
            dump_sass(sos, opt.sass, opt.sass_dir)

        # 2. Bits.
        whole, utile, ptile = inputs()
        data = {"packed2d": whole, "local2d": utile, "plocal2d": ptile}
        checks, fails = check_bits(libs, data)
        report["fails"] += fails
        log(f"bits: {checks} comparisons, {len(fails)} differ")

        # 3. Times: the libraries in turns, each mode's float32 twin beside.
        times = {}
        for name, (mod, leg, out) in MODES.items():
            sweeps = 4 if leg == "sweep" else 2
            call = Call(*launcher(mod, leg, data[mod], "rbgs", sweeps, 0.0,
                                  out))
            twin = Call(*launcher(mod, leg, data[mod], "rbgs", sweeps, 0.0,
                                  dtype=F32))
            fns = {label: call.fn(lib) for label, lib in libs.items()}
            fns["f32 twin"] = twin.fn(libs["this"])
            row = in_turns(fns)
            row["bound_ms"] = call.nbytes / PEAK_BYTES_PER_S * 1e3
            times[name] = row
            log(f"time {name}: {fmt(row)}; bound {row['bound_ms']:.4f}")
            del call, twin
        for name, call in main_legs(whole).items():
            row = in_turns({label: call.fn(libs[label])
                            for label in ("this", labels[0])})
            times[name] = row
            log(f"time {name}: {fmt(row)}")
        report["times"] = times
    for f in report["fails"]:
        log(f"FAIL {f}")
    line = json.dumps(report)
    if opt.json:
        opt.json.parent.mkdir(parents=True, exist_ok=True)
        opt.json.write_text(line)
    print(line)
    return 1 if report["fails"] else 0


if __name__ == "__main__":
    sys.exit(main())
