"""The device rule and the launch plumbing shared by the kernel wrappers.

Device rule: a CPU tensor takes the wrapper's plain PyTorch version; a
CUDA tensor launches the kernel or raises; any other device raises.

Storage rule. A kernel computes in float32 or float64. A kernel whose TPU
original follows ``_cdt`` (the JAX package's ``packed2d.py:74-90``) also
takes bfloat16 storage: the packed 2D tier (``packed2d``: the legs, the
sweep, the residual and the norm), the 3D kernel tier (``stencil3d``),
the shard tiles' legs (``local2d``, ``plocal2d``), the packed tile's
residual, apply and norm (``plocal2d``) and the BELL SpMM (``bell``). Each
load widens to float32, each output point rounds to bfloat16 once, any
coarse operand is float32, a norm is a float32 sum, and an output may be
stored in float32 (``out_dtype``: the up legs, the 3D sweeps; the 3D
residual always is, ``check_out_dtype``). A kernel whose TPU original
computes in bfloat16 itself (every operation rounded, sigma and the
constants bfloat16) has a native bfloat16 mode that does the same: the
residuals and sweeps of ``stencil2d`` and ``local2d``, the legs of
``fused2d`` and the transfers of ``transfer2d`` (``native_bf16``) and the
DIA SpMV (``spmv``); ``check_grid``'s ``storage`` lets their bfloat16
grids through.
"""
from __future__ import annotations

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64",
           torch.bfloat16: "bf16"}

# The dtypes a kernel computes in, and those the fine level of a mixed cycle
# may be stored in.
COMPUTE = (torch.float32, torch.float64)
STORAGE = COMPUTE + (torch.bfloat16,)



def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a kernel computes in for storage ``dtype``: float32 for
    bfloat16, else the dtype itself."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def check_out_dtype(what: str, t: torch.Tensor, out_dtype) -> torch.dtype:
    """The dtype a kernel stores its output in for input ``t``: t's own
    (``out_dtype`` None or t's dtype), or float32 for a bfloat16 ``t`` (the
    top level of a mixed cycle); any other ``out_dtype`` raises
    ValueError."""
    if out_dtype is None or out_dtype == t.dtype:
        return t.dtype
    if t.dtype == torch.bfloat16 and out_dtype == torch.float32:
        return out_dtype
    raise ValueError(f"{what}: out_dtype {out_dtype} for {t.dtype}: the "
                     "output is stored in the input's dtype, or in float32 "
                     "for bfloat16")


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 ref: torch.Tensor, dtype=None,
                 storage: bool = False) -> None:
    """Raise unless ``t`` is a contiguous float32 or float64 tensor (or,
    with ``storage``, bfloat16) of ``shape``, on ``ref``'s
    device and of ``ref``'s dtype (or of ``dtype``)."""
    want = ref.dtype if dtype is None else dtype
    if t.dtype not in (STORAGE if storage else COMPUTE):
        also = ", or bfloat16 storage" if storage else ""
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32 or "
                        f"float64{also})")
    if t.dtype != want or t.device != ref.device:
        raise ValueError(f"{name}: {t.dtype} on {t.device} does not match "
                         f"{want} on {ref.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def check_grid(name: str, t: torch.Tensor, n: int, ref: torch.Tensor,
               dtype=None, storage: bool = False) -> None:
    """``check_tensor`` for an (n+2, n+2) padded grid."""
    check_tensor(name, t, (n + 2, n + 2), ref, dtype, storage)


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain route for device {t.device}")


# Set by ``utils.debug`` (``debug_mode``, ``checked``) to a callable that
# takes an entry point's name and the tensors its launch wrote; None
# outside them, where a launch only tests this.
NAN_HOOK = None


def launch_on(t: torch.Tensor, kernel: str, *args, out_dtype=None,
              writes=()) -> None:
    """Call the C entry point ``mg_<kernel>_<f32|f64|bf16>`` for ``t``'s
    dtype (``_<f32>`` appended where ``out_dtype`` differs from it), on
    ``t``'s device and its current stream (passed last). ``writes``: the
    tensors the kernel writes, which ``NAN_HOOK`` is shown after the
    launch when it is set."""
    name = f"mg_{kernel}_{_SUFFIX[t.dtype]}"
    if out_dtype is not None and out_dtype != t.dtype:
        name += f"_{_SUFFIX[out_dtype]}"
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(name, *args, stream)
    if NAN_HOOK is not None:
        NAN_HOOK(name, writes)
