"""Debug mode: NaN trapping and checked numeric guards.

PyTorch port of ``multigridcmt_tpu.utils.debug``. JAX's tools are
``jax_debug_nans`` (fault on the first primitive whose output holds a
NaN) and ``checkify`` (checks carried through the computation as device
values, raised after it). Their counterparts here see two kinds of
operation: every PyTorch call (a ``TorchFunctionMode``) and every launch
of a hand-written kernel (``kernels._wrap.NAN_HOOK``, shown the tensors
the launch wrote), since on the card the first NaN of a solve usually
comes out of a kernel. An operation whose output holds a NaN is named by
its PyTorch function, or by the kernel's C entry point
(``mg_<kernel>_<dtype>``). Factories of uninitialised memory
(``torch.empty`` and its kin) are not checked.

* ``debug_mode()``: every such operation is checked as it returns (one
  host sync each: slow), and the first NaN raises ``NumericError``.
* ``checked(fn)``: the same checks and ``check_finite``'s are collected as
  device flags while ``fn`` runs, read in one sync at its end, and the
  first failure raises ``NumericError``.

Outside both, a kernel launch only tests ``NAN_HOOK`` and PyTorch calls
run as they are.
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

from ..kernels import _wrap


class NumericError(FloatingPointError):
    """A NaN produced where debug mode or ``checked`` traps it, or a failed
    ``check_finite``."""


class _Trap:
    """Where checks go: raised at once (``flags`` None) or collected as
    (what failed, 0-d bool device tensor) pairs."""

    def __init__(self, collect: bool):
        self.flags = [] if collect else None

    def note(self, what: str, bad: torch.Tensor) -> None:
        if self.flags is not None:
            self.flags.append((what, bad))
        elif bool(bad):
            raise NumericError(what)

    def raise_first(self) -> None:
        """One sync: raise for the first flag set, if any."""
        if not self.flags:
            return
        dev = self.flags[0][1].device
        bad = torch.stack([f.to(dev) for _, f in self.flags]).tolist()
        for (what, _), b in zip(self.flags, bad):
            if b:
                raise NumericError(what)


# The innermost trap first; None: NaN trapping off (``debug_mode(False)``).
_TRAPS: list = []


def _active():
    return _TRAPS[-1] if _TRAPS else None


def _tensors(out):
    """The tensors in an output (nested tuples, lists and dicts)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)


def _check_nans(what: str, outputs) -> None:
    trap = _active()
    if trap is None:
        return
    for t in _tensors(outputs):
        if (t.is_floating_point() and t.layout == torch.strided
                and t.numel() and t.device.type != "meta"):
            trap.note(f"{what} produced a NaN", torch.isnan(t).any())


def _kernel_hook(name: str, writes) -> None:
    _check_nans(f"kernel {name}", writes)


def _call_name(func) -> str:
    """torch.<name> or Tensor.<name> for a PyTorch callable."""
    name = getattr(func, "__qualname__", None) or repr(func)
    for prefix, public in (("_VariableFunctionsClass.", "torch."),
                           ("TensorBase.", "Tensor.")):
        if name.startswith(prefix):
            return public + name[len(prefix):]
    return name


class _NanMode(TorchFunctionMode):
    """Checks every PyTorch call's tensor outputs (JAX's per-primitive
    check)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if "empty" not in getattr(func, "__name__", ""):
            _check_nans(_call_name(func), out)
        return out


@contextlib.contextmanager
def _trapping(trap):
    """Make ``trap`` (or None: no trapping) the active one for a block,
    with the PyTorch-call mode and the kernel hook set while any trap is
    on."""
    first = not any(t is not None for t in _TRAPS)
    _TRAPS.append(trap)
    prev_hook = _wrap.NAN_HOOK
    _wrap.NAN_HOOK = _kernel_hook if trap is not None else None
    try:
        if first and trap is not None:
            with _NanMode():
                yield
        else:
            yield
    finally:
        _TRAPS.pop()
        _wrap.NAN_HOOK = prev_hook


def nans_enabled() -> bool:
    """True inside ``debug_mode()`` (JAX's ``jax_debug_nans``)."""
    return _active() is not None and _active().flags is None


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Fault on the first PyTorch call or kernel launch whose output holds a
    NaN within a block (``nans=False``: trap nothing in it); the previous
    state comes back on exit. Slow: each check syncs with the device."""
    with _trapping(_Trap(collect=False) if nans else None):
        yield


def check_finite(x: torch.Tensor, name: str = "array") -> None:
    """Assert that every element of ``x`` is finite: inside ``checked`` a
    device flag read at its end, elsewhere a check that raises now."""
    bad = ~torch.isfinite(x).all()
    trap = _active()
    if trap is not None and trap.flags is not None:
        trap.note(f"{name} contains NaN/Inf", bad)
    elif bool(bad):
        raise NumericError(f"{name} contains NaN/Inf")


def checked(fn):
    """Wrap ``fn`` so that a NaN any PyTorch call or kernel in it produces,
    and any failed ``check_finite``, surfaces as one ``NumericError``
    after it returns, naming the first (one sync at the end):

    >>> safe_solve = checked(lambda b: solver.solve(b).x)
    >>> x = safe_solve(b)      # raises NumericError on a NaN
    """
    def run(*args, **kwargs):
        trap = _Trap(collect=True)
        with _trapping(trap):
            out = fn(*args, **kwargs)
        trap.raise_first()
        return out

    return run
