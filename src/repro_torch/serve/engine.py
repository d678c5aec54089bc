"""Batched serving engine: prefill + greedy KV-cache decode (PyTorch twin of
``repro.serve.engine``)."""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from ..dist.fsdp import DPAxis
from ..dist.sharding import rows_of
from ..dist.tensor_parallel import all_gather
from ..models.registry import init_cache


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

    With a built ``mesh`` (the API's, ``get_api(mesh=...)``) the engine is
    one rank's: it takes the rank's rows of every input (``batch_specs``'
    cut, block ``dp_index``; every row where the DP ranks do not divide the
    batch), runs prefill and decode on them with the rank's cache, and
    all-gathers the greedy tokens over the DP group, so every rank returns
    the whole batch's tokens.
    """

    def __init__(self, api, model, batch: int, s_max: int, mesh=None):
        self.api = api
        self.model = model
        self.batch = batch
        self.s_max = s_max
        self.mesh = mesh
        self.dp = DPAxis.of(mesh) if mesh is not None else None
        self.timing: Dict[str, float] = {}

    @property
    def device(self) -> torch.device:
        return self.api.device

    def comm_profile(self) -> Dict[str, float]:
        """Per-request communication profile, measured off the cache tensors
        of one whole request (every tensor of the cache: each layer's entry,
        and whisper's encoder output ``enc``), the same on every rank of a
        mesh: the simulator reads a request's bytes, not a rank's share.
        ``kv_bytes_per_token`` is the byte growth of the unsharded cache
        (``models.registry.init_cache``, on the meta device) per context
        slot (MLA's compressed cache grows by c_kv and k_rope, L (R + Dr)
        entries; 0 for a recurrent state, which does not grow), and
        ``fixed_state_bytes`` is what does not grow (a recurrent state,
        whisper's ``enc``, the VLM's vision-prefix slots).  Its analytic
        twin is ``repro.dist.demand.kv_bytes_per_token`` (the tests pin the
        two).  The JAX engine's fixed bytes also count its int32 ``pos``
        leaf; the port keeps ``pos`` as a Python int."""
        cfg = self.api.cfg

        def nbytes(s_max: int) -> int:
            cache = init_cache(cfg, 1, s_max, "meta")
            return sum(t.nbytes for t in _tensors(cache))

        s0, s1 = 8, 16
        per_token = (nbytes(s1) - nbytes(s0)) / (s1 - s0)
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

    def local_inputs(self, batch_inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This rank's rows of every input (all of them without a mesh)."""
        if self.mesh is None:
            return dict(batch_inputs)
        out = {}
        for k, v in batch_inputs.items():
            v = np.asarray(v)
            r0, n = rows_of(v.shape[0], self.mesh)
            out[k] = v[r0:r0 + n]
        return out

    def _gather_rows(self, tokens: torch.Tensor, whole: int) -> torch.Tensor:
        """The rank's (rows, new) tokens joined over the DP group in its
        order, the batch's ``whole`` rows; as they are where the rank holds
        every row."""
        if self.dp is None or tokens.shape[0] == whole:
            return tokens
        out = tokens.new_empty((tokens.shape[0] * self.dp.size,) + tokens.shape[1:])
        all_gather(out, tokens.contiguous(), group=self.dp.group)
        return out

    @torch.inference_mode()
    def generate(self, batch_inputs: Dict[str, np.ndarray], max_new_tokens: int) -> np.ndarray:
        """Greedy generation from ``batch_inputs["tokens"]`` (B, S0) and the
        arch's other inputs (``frames``, ``patches``); returns (B,
        max_new_tokens) token ids, the whole batch's on every rank of a
        mesh.  Wall times of the prefill and of the decode steps (ended by
        a device synchronise; a rank's own on a mesh) go to
        ``self.timing``."""
        B, S0 = np.asarray(batch_inputs["tokens"]).shape
        if S0 + max_new_tokens > self.s_max:
            raise ValueError(f"prompt {S0} + {max_new_tokens} new tokens exceed s_max {self.s_max}")
        local = self.local_inputs(batch_inputs)
        tokens = torch.as_tensor(local["tokens"], dtype=torch.long)
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in local.items() if k != "tokens"}
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
        return self._gather_rows(torch.stack(out, dim=1), B).cpu().numpy()


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
