"""The device rule and the launch plumbing shared by the kernel wrappers.

Device rule: a CPU tensor takes the wrapper's plain PyTorch version; a
CUDA tensor launches the kernel or raises; any other device raises.
"""
from __future__ import annotations

import torch

from . import _build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

MIXED_TODO = ("{what}: bfloat16 storage (and a wider output dtype) belongs "
              "to mixed precision, not ported to CUDA yet (ROADMAP.md, queue "
              "1: mixed precision)")


def check_storage(what: str, t: torch.Tensor, out_dtype=None) -> None:
    """Raise NotImplementedError for the JAX kernels' bfloat16 storage and
    ``out_dtype`` widening, which the port's kernels do not take yet."""
    if t.dtype == torch.bfloat16 or (out_dtype is not None
                                     and out_dtype != t.dtype):
        raise NotImplementedError(MIXED_TODO.format(what=what))


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 ref: torch.Tensor) -> None:
    """Raise unless ``t`` is a contiguous float32/float64 tensor of
    ``shape``, on ``ref``'s device and of ``ref``'s dtype."""
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        "(float32 or float64)")
    if t.dtype != ref.dtype or t.device != ref.device:
        raise ValueError(f"{name}: {t.dtype} on {t.device} does not match "
                         f"{ref.dtype} on {ref.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def check_grid(name: str, t: torch.Tensor, n: int, ref: torch.Tensor) -> None:
    """``check_tensor`` for an (n+2, n+2) padded grid."""
    check_tensor(name, t, (n + 2, n + 2), ref)


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain route for device {t.device}")


def launch_on(t: torch.Tensor, kernel: str, *args) -> None:
    """Call the C entry point ``mg_<kernel>_<f32|f64>`` for ``t``'s dtype,
    on ``t``'s device and its current stream (passed last)."""
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(f"mg_{kernel}_{_SUFFIX[t.dtype]}", *args, stream)
