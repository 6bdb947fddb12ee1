"""Distributed multigrid over ``torch.distributed`` (``sharded.py``)."""
