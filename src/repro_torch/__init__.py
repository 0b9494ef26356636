"""PyTorch/CUDA port of the cluster-admission system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``sim/``, ``tuning/``, ``configs/``,
``benchmarks/``) and public names for the parts ported so far, and imports
nothing of it. Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``.
"""
