"""Batched serving engine: prefill + greedy KV-cache decode (PyTorch twin of
``repro.serve.engine``)."""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch


class ServeEngine:
    """Inference engine over one ModelAPI, on the API's device (``cuda``
    unless the API was built for another).

    ``generate`` runs greedy decoding: one prefill over the prompts that
    computes only the last position's logits (``last_only``; the JAX engine
    computes the whole sequence's and reads the last, which gives the same
    tokens), then one decode step per further token against the cache (KV
    or recurrent state), which the model updates in place.
    Every other entry of the batch (whisper's ``frames``, the VLM's
    ``patches``) goes to the prefill on the device as it is; the model
    casts it to the compute dtype.
    ``comm_profile`` exports the engine's communication footprint, which
    calibrates the cluster simulator's serving archetype.
    """

    def __init__(self, api, model, batch: int, s_max: int):
        self.api = api
        self.model = model
        self.batch = batch
        self.s_max = s_max
        self.timing: Dict[str, float] = {}

    @property
    def device(self) -> torch.device:
        return self.api.device

    def comm_profile(self) -> Dict[str, float]:
        """Per-request communication profile, measured off the engine's own
        cache tensors (every tensor of the cache: each layer's entry, and
        whisper's encoder output ``enc``):
        ``kv_bytes_per_token`` is the byte growth of ``api.init_cache`` per
        context slot (MLA's compressed cache grows by c_kv and k_rope,
        L (R + Dr) entries; 0 for a recurrent state, which does not grow), and
        ``fixed_state_bytes`` is what does not grow (a recurrent state,
        whisper's ``enc``, the VLM's vision-prefix slots).  Its analytic
        twin is ``repro.dist.demand.kv_bytes_per_token`` (the tests pin the
        two).  The JAX engine's fixed bytes also count its int32 ``pos``
        leaf; the port keeps ``pos`` as a Python int."""
        def nbytes(s_max: int) -> int:
            cache = self.api.init_cache(1, s_max)
            return sum(t.nbytes for t in _tensors(cache))

        s0, s1 = 8, 16
        per_token = (nbytes(s1) - nbytes(s0)) / (s1 - s0)
        cfg = self.api.cfg
        return {
            "kv_bytes_per_token": float(per_token),
            "fixed_state_bytes": float(nbytes(s0) - per_token * s0),
            "dtype_bytes": float(cfg.cdtype.itemsize),
            "num_layers": float(cfg.num_layers),
            "batch_slots": float(self.batch),
        }

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, batch_inputs: Dict[str, np.ndarray], max_new_tokens: int) -> np.ndarray:
        """Greedy generation from ``batch_inputs["tokens"]`` (B, S0) and the
        arch's other inputs (``frames``, ``patches``); returns (B,
        max_new_tokens) token ids.  Wall times of the prefill and of the
        decode steps (ended by a device synchronise) go to ``self.timing``."""
        tokens = torch.as_tensor(np.asarray(batch_inputs["tokens"]), dtype=torch.long)
        B, S0 = tokens.shape
        if S0 + max_new_tokens > self.s_max:
            raise ValueError(f"prompt {S0} + {max_new_tokens} new tokens exceed s_max {self.s_max}")
        batch = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                 for k, v in batch_inputs.items() if k != "tokens"}
        batch["tokens"] = tokens.to(self.device)
        t0 = time.perf_counter()
        cache = self.api.init_cache(B, self.s_max)
        logits, cache = self.api.prefill(self.model, batch, cache, last_only=True)
        tok = logits[:, -1].argmax(dim=-1)
        out = [tok]
        self._sync()
        t1 = time.perf_counter()
        for _ in range(max_new_tokens - 1):
            logits, cache = self.api.decode(self.model, tok[:, None], cache)
            tok = logits[:, -1].argmax(dim=-1)
            out.append(tok)
        self._sync()
        t2 = time.perf_counter()
        self.timing = {"prefill_s": t1 - t0, "decode_s": t2 - t1,
                       "decode_steps": float(max_new_tokens - 1)}
        return torch.stack(out, dim=1).cpu().numpy()


def _tensors(tree):
    """Every tensor of a cache: its dict values, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
