"""Mixture-of-Experts FFN with capacity-based dispatch (PyTorch twin of
``repro.models.moe``).

The router runs in fp32 (its weight stays fp32 whatever ``param_dtype`` is,
as JAX's ``init_moe`` makes it), picks the top k experts by softmax or
sigmoid score and renormalises their gates.  Each expert takes at most
C = ceil(T k / E x capacity_factor) tokens; a token's slot at its expert is
the number of earlier (token, k) picks of that expert, so the lowest token
index gets the slot and the overflow is dropped, as in JAX.  The (E, C)
dispatch table points each slot at its token, or at a zero pad row when the
slot is empty, and an index gather makes the experts' (E, C, d) input.  The
experts are batched products over the expert axis (plain products, as in
JAX, which computes them outside any Pallas kernel).

The combine differs from JAX's scatter-add in how, not in what: each
token gathers its k outputs through the inverse of the dispatch table and
adds them in k order, so no atomics are involved and two runs on the card
give the same bits.  The Switch-style auxiliary loss comes from the softmax
of the router logits for both routers, as in JAX.

On a rank of a ``model`` axis (``dist.tensor_parallel``) the routing runs
on the replicated residual stream with the router gathered whole (JAX cuts
its expert columns), so the dispatch table is the same on every rank of
the axis.  Where the axis divides the experts (expert parallelism) each
rank runs its own experts' rows of the table; else, where it divides the
experts' FFN width, every expert on its column slice.  Either way the
combine is a partial sum that is all-reduced.  The shared experts are
column/row-parallel MLPs.

In serving where the DP axes cut the batch (``rows_dp``: the group of
ranks that hold its other rows, the cache's ``"dp"``,
``transformer.init_cache``) the capacity and the slots are the whole batch's,
as JAX's sharded prefill and decode compute them: each rank counts its
picks of each expert, the counts are all-gathered over the group, and a
pick keeps its slot if the picks of the ranks before it (in the group's
order, which is the batch's row order) and its own earlier ones leave room
under C = ceil(T_all k / E x capacity_factor).  Where the DP ranks do not
divide the batch, each holds every row and routes it alone, as JAX does on
a replicated batch.  The train step keeps each rank's own routing, as JAX's
hierarchical step does.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..dist import tensor_parallel as tp
from ..dist.tensor_parallel import all_gather
from .layers import MLP, _param, dense_init, mlp_parallel, stacked_init


class Routing(NamedTuple):
    expert_idx: torch.Tensor  # (T, k) int64, the experts of each token, best first
    gate_vals: torch.Tensor  # (T, k) fp32, renormalised gates
    dispatch: torch.Tensor  # (E, C) int64, token of each expert slot (T = empty)
    gates_ec: torch.Tensor  # (E, C) fp32, gate of each expert slot (0 = empty)
    slot: torch.Tensor  # (T, k) int64, flat slot e*C + c of each pick (E*C = dropped)
    aux: torch.Tensor  # () fp32, the load-balance loss


def route(mod: "MoE", xt: torch.Tensor, cfg, capacity: Optional[int] = None,
          rows_dp=None) -> Routing:
    """Router, top-k, aux loss and capacity slotting of tokens ``xt`` (T, d);
    with ``rows_dp`` (a ``dist.fsdp.DPAxis`` whose ranks hold the batch's
    other rows), of the rank's tokens among the whole batch of the group's
    ranks (module docstring)."""
    e = cfg.moe
    T = xt.shape[0]
    E, k = e.num_experts, e.top_k
    # the router, cut along its expert columns over the model axis, is
    # gathered whole: the routing runs on the replicated residual stream
    logits = xt.float() @ tp.whole(mod.router, tp.axis_of(mod)).float()
    scores = torch.sigmoid(logits) if e.router == "sigmoid" else torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(scores, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    probs = torch.softmax(logits, dim=-1)
    ce = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(probs.mean(dim=0) * ce)

    # a pick's position among the picks of its expert, in flat (token, k) order
    flat_e = expert_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=xt.device) - first[flat_e[order]]
    T_all, before = T, 0
    if rows_dp is not None:
        every = counts.new_empty((rows_dp.size * E,))
        rows_dp.count(every)
        all_gather(every, counts, group=rows_dp.group)
        before = every.view(rows_dp.size, E)[:rows_dp.index].sum(0)[flat_e]
        T_all = T * rows_dp.size
    C = capacity if capacity is not None else int(math.ceil(T_all * k / E * e.capacity_factor))
    C = max(C, 1)
    keep = pos + before < C
    # over a DP group the table holds the rank's picks: at most T an expert
    width = C if T_all == T else min(C, T)
    tok_of = torch.arange(T, device=xt.device).repeat_interleave(k)

    dispatch = torch.full((E, width), T, dtype=torch.long, device=xt.device)
    dispatch[flat_e[keep], pos[keep]] = tok_of[keep]
    gates_ec = torch.zeros((E, width), dtype=torch.float32, device=xt.device)
    gates_ec[flat_e[keep], pos[keep]] = gate_vals.reshape(-1)[keep]
    slot = torch.where(keep, flat_e * width + pos, E * width).reshape(T, k)
    return Routing(expert_idx, gate_vals, dispatch, gates_ec, slot, aux)


def _expert_ffn(mod: "MoE", x: torch.Tensor, cfg) -> torch.Tensor:
    """x (E, C, d) -> (E, C, d), batched over the experts."""
    h = torch.bmm(x, mod.wi.to(x.dtype))
    if cfg.mlp_kind in ("swiglu", "geglu"):
        g = torch.bmm(x, mod.wg.to(x.dtype))
        act = F.silu(g) if cfg.mlp_kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * h
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, mod.wo.to(x.dtype))


def moe_mlp(mod: "MoE", x: torch.Tensor, cfg, capacity: Optional[int] = None,
            rows_dp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d), aux fp32 scalar).  x: (B, S, d); ``rows_dp`` as
    :func:`route`."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    r = route(mod, xt, cfg, capacity, rows_dp)
    E, C = r.dispatch.shape

    xpad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    dispatch, gates, slot = r.dispatch, r.gates_ec, r.slot
    axis = tp.axis_of(mod)
    # the rank's experts (expert dim cut) or every expert on its FFN columns;
    # where the axis divides neither, the stacks are whole on every rank
    split = axis is not None and (tp.sliced(mod.wi, 0) or tp.sliced(mod.wi, -1))
    if split:
        xpad, gates = tp.copy_to(xpad, axis), tp.copy_to(gates, axis)
    if split and tp.sliced(mod.wi, 0):
        e0, e1 = axis.index * mod.wi.shape[0], (axis.index + 1) * mod.wi.shape[0]
        dispatch, gates = dispatch[e0:e1], gates[e0:e1]
        # a pick of another rank's expert reads the zero row
        slot = torch.where((slot >= e0 * C) & (slot < e1 * C), slot - e0 * C, (e1 - e0) * C)
        E = e1 - e0
    out = _expert_ffn(mod, xpad[dispatch], cfg)  # (E, C, d)
    out = out * gates[..., None].to(out.dtype)

    # combine: each token's k outputs through the inverse of the dispatch
    # table (a dropped pick reads the zero row), added in k order
    out = torch.cat([out.reshape(E * C, d), out.new_zeros((1, d))], dim=0)
    y = out.new_zeros((T, d))
    for j in range(slot.shape[1]):
        y = y + out[slot[:, j]]
    if split:
        y = tp.reduce_from(y, axis)

    if cfg.moe.num_shared:
        sh = mod.shared
        # JAX's shared experts gate with silu whatever mlp_kind
        y = y + mlp_parallel(sh, xt, "swiglu" if hasattr(sh, "wg") else "gelu")
    return y.reshape(B, S, d), r.aux


class MoE(nn.Module):
    """Parameters of one MoE FFN, named as JAX's ``init_moe`` names them:
    ``router`` (d, E) fp32, the expert stacks ``wi``/``wg`` (E, d, f) and
    ``wo`` (E, f, d), and ``shared.{wi,wg,wo}`` for ``num_shared`` always-on
    experts of width ``num_shared * d_expert``."""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        e, d = cfg.moe, cfg.d_model
        E, f = e.num_experts, e.d_expert
        self.router = nn.Parameter(torch.empty((d, E), dtype=torch.float32, device=device))
        self.wi = _param((E, d, f), cfg, device)
        if cfg.mlp_kind in ("swiglu", "geglu"):
            self.wg = _param((E, d, f), cfg, device)
        self.wo = _param((E, f, d), cfg, device)
        if e.num_shared:
            self.shared = MLP(cfg, device, d_ff=f * e.num_shared)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The router and the stacks (``shared`` is reset as a module of its own)."""
        dense_init(self.router.data, gen)
        for w in (self.wi, getattr(self, "wg", None), self.wo):
            if w is not None:
                stacked_init(w.data, gen)

    def forward(self, x: torch.Tensor, rows_dp=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_mlp(self, x, self.cfg, rows_dp=rows_dp)
