"""Matplotlib plot artifacts matching the reference's demo outputs.

PyTorch port of ``multigridcmt_tpu.utils.plots``: residual-history decay,
FMG error against the grid side, and eigenmode pictures, from tensors (on
any device) or arrays; every example CLI writes them behind ``--plot
FILE``. Headless (the Agg backend). matplotlib is imported only when a
plot is drawn, and its absence raises ``ImportError`` then.
"""
from __future__ import annotations

import numpy as np
import torch


def _plt():
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plotting (--plot) needs matplotlib, which is not "
                          "installed in this Python") from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(a, dtype=None) -> np.ndarray:
    """A tensor (any device) or array-like as a host array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def plot_residual_history(histories, path: str, title: str = ""):
    """Semilogy relative-residual decay; `histories` maps label -> 1D array
    (trailing repeated entries past convergence are trimmed)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, hist in histories.items():
        h = _host(hist, float)
        keep = len(h)
        while keep > 2 and h[keep - 1] == h[keep - 2]:
            keep -= 1
        ax.semilogy(np.arange(keep), h[:keep], marker="o", ms=3, label=label)
    ax.set_xlabel("V-cycle")
    ax.set_ylabel(r"$\|r_k\| / \|r_0\|$")
    ax.grid(True, which="both", alpha=0.3)
    if title:
        ax.set_title(title)
    if len(histories) > 1 or any(histories):
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=140)
    plt.close(fig)


def plot_error_convergence(ns, errs, path: str, title: str = "FMG accuracy"):
    """Log-log discrete-L2 error vs n with an O(h^2) guide line."""
    plt = _plt()
    ns = _host(ns, float)
    errs = _host(errs, float)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.loglog(ns, errs, marker="o", label="FMG discrete-$L_2$ error")
    guide = errs[0] * (ns[0] / ns) ** 2
    ax.loglog(ns, guide, "k--", alpha=0.6, label=r"$O(h^2)$")
    ax.set_xlabel("grid side $n$")
    ax.set_ylabel("error")
    ax.grid(True, which="both", alpha=0.3)
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=140)
    plt.close(fig)


def plot_eigenmodes(vectors, n: int, ndim: int, eigenvalues, path: str):
    """Grid of computed eigenmodes (2D: imshow; 1D: line plots)."""
    plt = _plt()
    vecs = _host(vectors)
    k = vecs.shape[0] if vecs.ndim > ndim else 1
    vecs = vecs.reshape((k,) + (n,) * ndim)
    lams = np.atleast_1d(_host(eigenvalues, float))
    cols = min(k, 3)
    rows = -(-k // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3.2 * cols, 2.8 * rows),
                             squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        if i >= k:
            ax.axis("off")
            continue
        if ndim == 2:
            ax.imshow(vecs[i], cmap="RdBu_r", origin="lower")
            ax.set_xticks([])
            ax.set_yticks([])
        else:
            ax.plot(vecs[i])
        ax.set_title(rf"$\lambda_{{{i + 1}}}$ = {lams[i]:.5f}", fontsize=9)
    fig.tight_layout()
    fig.savefig(path, dpi=140)
    plt.close(fig)
