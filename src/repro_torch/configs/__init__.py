"""Selectable architecture configs (``--arch <id>``).

One module per assigned architecture, each the canonical definition of the
full-scale :class:`~repro_torch.models.config.ModelConfig` plus the
:class:`~repro_torch.configs.common.ParallelismPlan` mapping the arch onto
the paper's cluster.  Same ids and values as ``repro.configs``.
"""
from __future__ import annotations

import importlib
from typing import Dict

from .common import ParallelismPlan, job_demand

_MODULES: Dict[str, str] = {
    "deepseek-v3-671b": "deepseek_v3_671b",
    "grok-1-314b": "grok_1_314b",
    "internvl2-1b": "internvl2_1b",
    "gemma-2b": "gemma_2b",
    "qwen2.5-14b": "qwen2_5_14b",
    "gemma2-9b": "gemma2_9b",
    "olmo-1b": "olmo_1b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "whisper-small": "whisper_small",
}

ARCH_IDS = tuple(_MODULES)


def arch_module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {sorted(_MODULES)}")
    return importlib.import_module(f".{_MODULES[arch_id]}", __package__)


def get_config(arch_id: str):
    """The exact full-scale ModelConfig for ``--arch <id>``."""
    return arch_module(arch_id).config()


def get_plan(arch_id: str) -> ParallelismPlan:
    """The arch's cluster parallelism plan."""
    return arch_module(arch_id).PLAN


__all__ = ["ARCH_IDS", "ParallelismPlan", "arch_module", "get_config", "get_plan", "job_demand"]
