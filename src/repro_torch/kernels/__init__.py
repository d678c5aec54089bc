"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch.

* :mod:`.flash_attention` — flash attention, CUDA C++: the forward
  (``csrc/flash_attention.cu``) and the backward
  (``csrc/flash_attention_bwd.cu``), built by :mod:`.build` at first use.
* :mod:`.rmsnorm` — fused RMSNorm, forward and backward, Triton.
* :mod:`.wkv6` — the RWKV-6 WKV recurrence, CUDA C++ (``csrc/wkv6.cu``).

``ops`` is the entry layer the models call; ``ref`` holds the plain
versions.  Every Pallas kernel of the JAX package has its twin here.
"""
from . import ops, ref
from .flash_attention import flash_attention, flash_attention_bwd
from .rmsnorm import rmsnorm, rmsnorm_bwd
from .wkv6 import wkv6

__all__ = ["ops", "ref", "flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd",
           "wkv6"]
