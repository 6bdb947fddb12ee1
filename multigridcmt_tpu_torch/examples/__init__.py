"""The example CLIs, ported from the JAX package's ``examples/``: the
BASELINE configs 1-5 and the 3D demo. Each runs as

    python -m multigridcmt_tpu_torch.examples.<name> [flags]

on the card (``--device cpu`` runs on the CPU; with no card and no
``--device cpu`` it raises), and ``main(argv)`` runs it in-process and
returns its result. The flags, defaults and printed lines are JAX's;
``--pallas`` is ``--kernels`` (``use_kernels``). ``--plot FILE`` needs
matplotlib.
"""
