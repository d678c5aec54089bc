"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

* :mod:`.flash_attention` — forward flash attention, CUDA C++
  (``csrc/flash_attention.cu``), built by :mod:`.build` at first use.
* :mod:`.rmsnorm` — fused RMSNorm, Triton.
* :mod:`.wkv6` — the RWKV-6 WKV recurrence, CUDA C++ (``csrc/wkv6.cu``).

``ops`` is the entry layer the models call; ``ref`` holds the plain
versions.  Every Pallas kernel of the JAX package has its twin here.
"""
from . import ops, ref
from .flash_attention import flash_attention
from .rmsnorm import rmsnorm
from .wkv6 import wkv6

__all__ = ["ops", "ref", "flash_attention", "rmsnorm", "wkv6"]
