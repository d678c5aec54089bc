"""PyTorch/CUDA port of the repository's data plane (``repro``'s models,
kernels and serving engine) for an NVIDIA H100.

It imports ``torch`` and never ``jax``, and nothing of the ``repro``
package: what it needs of it, it keeps a copy of.  Entry points run on
``cuda`` unless the caller passes another device.
"""
