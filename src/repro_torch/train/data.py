"""Deterministic, shardable synthetic data pipeline (the port's copy of
``repro.train.data``, which is numpy only; the port imports nothing of
``repro``, so it keeps this copy, and its batches equal the JAX package's
bit for bit).

Every batch is a pure function of (seed, step, arch), so:

* any host can generate exactly its shard (multi-host determinism),
* restart-from-checkpoint resumes the stream with no state to save,
* straggler mitigation / elastic rescale just re-partitions index ranges.

Two token distributions:

* ``mode="affine"``: next = (a·tok + b) mod V — a *learnable* structure, so
  tiny smoke-training runs show decreasing loss (used by integration tests).
* ``mode="uniform"``: i.i.d. tokens (throughput benchmarking).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int  # global batch
    seq: int
    seed: int = 0
    mode: str = "affine"  # affine | uniform
    a: int = 31
    b: int = 7


class SyntheticData:
    def __init__(self, cfg: DataConfig, model_cfg=None):
        self.cfg = cfg
        self.model_cfg = model_cfg

    def _tokens(self, step: int, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of the global batch at `step` (deterministic)."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        if c.mode == "uniform":
            all_rows = rng.integers(0, c.vocab_size, size=(c.batch, c.seq))
            return all_rows[lo:hi].astype(np.int32)
        starts = rng.integers(0, c.vocab_size, size=(c.batch,))[lo:hi]
        toks = np.empty((hi - lo, c.seq), dtype=np.int64)
        toks[:, 0] = starts
        for t in range(1, c.seq):
            toks[:, t] = (c.a * toks[:, t - 1] + c.b) % c.vocab_size
        return toks.astype(np.int32)

    def batch_at(self, step: int, lo: int = 0, hi: Optional[int] = None) -> Dict[str, np.ndarray]:
        c = self.cfg
        hi = hi if hi is not None else c.batch
        toks = self._tokens(step, lo, hi)
        nxt = (c.a * toks.astype(np.int64) + c.b) % c.vocab_size if c.mode == "affine" else np.roll(toks, -1, 1)
        out = {"tokens": toks, "targets": nxt.astype(np.int32)}
        m = self.model_cfg
        if m is not None and m.family == "audio":
            rng = np.random.default_rng((c.seed, step, 1))
            out["frames"] = rng.normal(size=(hi - lo, m.encoder_seq, m.d_model)).astype(
                np.float32
            )
        if m is not None and m.family == "vlm":
            rng = np.random.default_rng((c.seed, step, 2))
            out["patches"] = rng.normal(
                size=(hi - lo, m.vision_tokens, m.vision_dim)
            ).astype(np.float32)
        return out
