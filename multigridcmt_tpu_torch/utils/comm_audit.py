"""Communication audit: count the collectives a sharded run makes, and
their bytes, once per execution.

PyTorch port of ``multigridcmt_tpu.utils.comm_audit``. JAX's walks the
traced jaxpr, so a collective inside a loop body counts once however many
times the loop runs (ROADMAP.md, queue 3, F2). This one wraps the calls
the port makes while a block runs, so every execution counts:

* ``ppermute``: ``parallel.sharded._swap``, JAX's unit: one slab offered
  along one mesh axis in one direction is one ppermute, whether or not
  this rank has a neighbour there; its bytes are the slab's;
* ``psum``: ``torch.distributed.all_reduce`` (the tensor's bytes);
* ``all_gather``: ``torch.distributed.all_gather`` (this rank's operand);
* ``broadcast``: ``torch.distributed.broadcast`` (the tensor's bytes; JAX
  has no such collective: its sharded eigensolve starts every device from
  the same replicated block);
* ``sent``: the point-to-point messages this rank really posted (the
  ``isend`` ops of ``torch.distributed.batch_isend_irecv``) and their
  bytes: a mesh of 1 sends none.

>>> with comm_audit() as audit:
...     solver.solve(b)
>>> audit.report()
{'counts': {'ppermute': ..., 'psum': ...}, 'bytes': {...},
 'sent': {'messages': ..., 'bytes': ...}}
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class comm_audit:                                           # noqa: N801
    """Counts, while active, the port's exchanges and collectives per
    execution (patched on entry, restored on exit, as
    ``profiling.count_cycles`` does); ``report()`` gives JAX's
    ``{"counts": {...}, "bytes": {...}}`` plus ``"sent"``."""

    def __enter__(self):
        from ..parallel import sharded

        self.counts, self.bytes = {}, {}
        self.sent = {"messages": 0, "bytes": 0}
        swap, all_reduce, all_gather, broadcast, batch = self._saved = (
            sharded._swap, dist.all_reduce, dist.all_gather, dist.broadcast,
            dist.batch_isend_irecv)

        def counted_swap(to_upper, to_lower, mesh, mesh_axis):
            for slab in (to_upper, to_lower):
                if slab is not None:
                    self._count("ppermute", slab)
            return swap(to_upper, to_lower, mesh, mesh_axis)

        def counted_all_reduce(tensor, *args, **kwargs):
            self._count("psum", tensor)
            return all_reduce(tensor, *args, **kwargs)

        def counted_all_gather(parts, tensor, *args, **kwargs):
            self._count("all_gather", tensor)
            return all_gather(parts, tensor, *args, **kwargs)

        def counted_broadcast(tensor, *args, **kwargs):
            self._count("broadcast", tensor)
            return broadcast(tensor, *args, **kwargs)

        def counted_batch(ops):
            for op in ops:
                if op.op is dist.isend:
                    self.sent["messages"] += 1
                    self.sent["bytes"] += _nbytes(op.tensor)
            return batch(ops)

        sharded._swap = counted_swap
        dist.all_reduce = counted_all_reduce
        dist.all_gather = counted_all_gather
        dist.broadcast = counted_broadcast
        dist.batch_isend_irecv = counted_batch
        return self

    def __exit__(self, *exc):
        from ..parallel import sharded

        (sharded._swap, dist.all_reduce, dist.all_gather, dist.broadcast,
         dist.batch_isend_irecv) = self._saved
        return False

    def _count(self, prim: str, operand: torch.Tensor) -> None:
        self.counts[prim] = self.counts.get(prim, 0) + 1
        self.bytes[prim] = self.bytes.get(prim, 0) + _nbytes(operand)

    def report(self) -> dict:
        return {"counts": dict(self.counts), "bytes": dict(self.bytes),
                "sent": dict(self.sent)}
