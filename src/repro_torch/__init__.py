"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``repro``'s module names so each module's counterpart is easy to
find, imports nothing of ``repro`` or ``jax``, and sends every kernel on its
path through a hand-written Hopper kernel (``csrc/``, built at first use).
Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
"""
