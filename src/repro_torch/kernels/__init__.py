"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

* :mod:`.flash_attention` — forward flash attention, CUDA C++
  (``csrc/flash_attention.cu``), built by :mod:`.build` at first use.
* :mod:`.rmsnorm` — fused RMSNorm, Triton.

``ops`` is the entry layer the models call; ``ref`` holds the plain
versions.  The RWKV-6 WKV kernel of the JAX package is not ported yet.
"""
from . import ops, ref
from .flash_attention import flash_attention
from .rmsnorm import rmsnorm

__all__ = ["ops", "ref", "flash_attention", "rmsnorm"]
