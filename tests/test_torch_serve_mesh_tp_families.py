"""The port's sharded serving of rwkv6, jamba, whisper and internvl2 over the
model axis against JAX's, on the CPU.

* Prefill and 5 greedy decode steps on 4 gloo ranks
  (``tests/torch_dist_ranks.py``, serve tasks) against JAX's jitted sharded
  prefill and decode (``tests/jax_dist_reference.py``, serve cases) on a
  forced 4-device host mesh, from the same weights and prompts: the smoke
  configs in fp32, batch 4, a prompt of 8 tokens and 6 new ones, at (pod,
  data, model) = (1, 1, 4) and (1, 2, 2).  rwkv6's time mix is
  head-parallel, jamba's Mamba mixers channel-parallel (with its GQA layer
  and its experts over the axis), whisper's self- and cross-attentions
  head-parallel, internvl2's projector a Megatron pair.  rwkv6 and whisper
  also with 2 heads at (1, 1, 4), where every rank computes their whole
  mixes and attentions from gathered weights.
* Each rank's logits within 2e-5 of JAX's rows; greedy tokens equal; each
  of jamba's MoE layers' top-k experts and kept picks equal.
* Each rank's cache after the prefill and after the last step against the
  part of JAX's cache it holds: its rows, and its kv heads (the kv heads
  its query heads read), its heads' WKV states, its Mamba channels; the
  token-shift states and whisper's ``enc`` whole.  Its bytes against
  ``cache_specs``' block, leaf by leaf, at the stated multiple: 1.00x where
  the rank holds the block ``cache_specs`` cuts (whole kv heads, the Mamba
  channels, the WKV states of its heads, which are the bytes of JAX's cut
  along the key dim in another layout); ``model``x for the token-shift
  states (``cache_specs`` cuts ``d``, the shift reads all of it) and for
  whisper's ``enc`` (cut over its frames, every frame feeds the rank's
  heads); 2.00x for a kv head cut inside ``head_dim`` at model 4 (the smoke
  configs' 2 kv heads), held whole; where every rank computes the whole
  mix or attention, its WKV states or kv heads whole (``model``x).
* The cache after the last step reassembled from every rank's pieces
  covers JAX's whole cache and equals it.
* A decode step moves fewer bytes over ``model`` than one unembedding table
  (jamba: and its Mamba layers' gathered ``x_proj``, ``dt_proj`` and
  ``A_log``).
* The serve CLI under ``torch.distributed.run`` with ``--model 2`` prints
  the single-device CLI's tokens for rwkv6.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.dist.sharding import cache_specs, spec_slice  # noqa: E402
from repro_torch.launch.mesh import mesh_layout  # noqa: E402
from repro_torch.models import get_api, modality_inputs, smoke_config  # noqa: E402
from repro_torch.models.attention import kv_heads  # noqa: E402
from repro_torch.models.convert import cache_leaves, cache_shapes, params_to_jax  # noqa: E402
from repro_torch.models.rwkv import local_heads, rwkv_dims  # noqa: E402
from repro_torch.models.ssm import local_channels  # noqa: E402
from repro_torch.models.transformer import layer_plan  # noqa: E402
from tests.test_torch_serve_mesh import (BATCH, LOGIT_ATOL, NEW, PROMPT, S_MAX, _cfg,  # noqa: E402
                                         _cli, _rows)
from tests.torch_dist_ranks import jax_process, run_ranks, wait_all  # noqa: E402

AXES = ("pod", "data", "model")
M114, M122 = [(1, 1, 4), AXES], [(1, 2, 2), AXES]
ARCHS = {"rwkv": "rwkv6-1.6b", "jamba": "jamba-1.5-large-398b", "whisper": "whisper-small",
         "internvl2": "internvl2-1b"}
# 2 heads over 4 ranks: every rank computes rwkv6's whole time mix, and
# whisper's whole attentions and cross-attentions, from gathered weights
WHOLE = {"rwkv": {"rwkv": {"head_dim": 32}},
         "whisper": {"num_heads": 2, "num_kv_heads": 2, "head_dim": 32}}
# name -> (arch, mesh, cfg overrides); the port's case and JAX's share the name
CASES = {f"{short}-{''.join(map(str, m[0]))}": (arch, m, {})
         for short, arch in ARCHS.items() for m in (M114, M122)}
WHOLE_CASES = {f"{short}-114-whole": (ARCHS[short], M114, over) for short, over in WHOLE.items()}
CASES.update(WHOLE_CASES)
# each case's rank cache against cache_specs' block, by kind (module docstring)
MULTIPLES = {"rwkv-114": {"x_prev": 4, "wkv": 1}, "rwkv-122": {"x_prev": 2, "wkv": 1},
             "jamba-114": {"kv": 2, "mamba": 1}, "jamba-122": {"kv": 1, "mamba": 1},
             "whisper-114": {"kv": 2, "enc": 4}, "whisper-122": {"kv": 1, "enc": 2},
             "internvl2-114": {"kv": 2}, "internvl2-122": {"kv": 1},
             "rwkv-114-whole": {"x_prev": 4, "wkv": 4},
             "whisper-114-whole": {"kv": 4, "enc": 4}}


def _write_inputs(d, name, cfg):
    """The single-device port's ``init(0)`` weights of ``cfg`` as JAX's flat
    leaves and BATCH prompts (a fixed generator): (weights, prompts)."""
    model = get_api(cfg, device="cpu").init(0)
    paths = os.path.join(d, f"{name}.params.npz"), os.path.join(d, f"{name}.inputs.npz")
    np.savez(paths[0], **{f"params/{k}": a
                          for k, a in params_to_jax(model.state_dict(), cfg).items()})
    rng = np.random.default_rng(7)
    np.savez(paths[1], tokens=rng.integers(0, cfg.vocab_size, size=(BATCH, PROMPT)).astype(
        np.int64), **modality_inputs(cfg, rng, BATCH))
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_mesh_tp"))
    sv = dict(fsdp=False, max_new=NEW, s_max=S_MAX)
    cases = [dict(name=n, arch=a, mesh=m, cfg=over, serve=sv,
                  **dict(zip(("init", "inputs"), _write_inputs(d, n, _cfg(a, over)))))
             for n, (a, m, over) in CASES.items()]
    procs = [jax_process({"devices": 4, "out": d, "cases": cases[i::2]},
                         os.path.join(d, f"jax{i}.json")) for i in range(2)]
    try:
        run_ranks({"world": 4, "store": os.path.join(d, "store"), "out": d, "tasks": cases},
                  os.path.join(d, "ranks.json"))
    finally:
        wait_all(procs, 300)
    out = {}
    for n in CASES:
        with np.load(os.path.join(d, f"{n}.jax.npz")) as f:
            want = dict(f)
        ranks = []
        for r in range(4):
            with np.load(os.path.join(d, f"{n}.rank{r}.npz")) as f:
                ranks.append(dict(f))
        out[n] = want, ranks
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_tokens_match_jax(runs, name):
    want, ranks = runs[name]
    for res in ranks:
        r0, n = _rows(res["coords"], CASES[name][1][0])
        for i in range(NEW):
            err = np.abs(res[f"logits/{i}"] - want[f"logits/{i}"][r0:r0 + n]).max()
            assert err <= LOGIT_ATOL, (name, tuple(res["coords"]), i, err)
        np.testing.assert_array_equal(res["tokens"], want["tokens"])


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("jamba")])
def test_routing_matches_jax(runs, name):
    """Each MoE layer's top-k experts of every token and the picks each
    expert kept, over the ranks at model coordinate 0 (their rows are the
    batch)."""
    want, ranks = runs[name]
    shape = CASES[name][1][0]
    calls = len([k for k in want if k.startswith("routing/")])
    moe_layers = sum(s.moe for s in layer_plan(smoke_config(CASES[name][0])).layers())
    assert calls == NEW * moe_layers > 0
    mine = sorted((r for r in ranks if r["coords"][2] == 0),
                  key=lambda r: _rows(r["coords"], shape)[0])
    for i in range(calls):
        np.testing.assert_array_equal(np.concatenate([r[f"routing/{i}"] for r in mine]),
                                      want[f"routing/{i}"], err_msg=f"{name} call {i}")
        np.testing.assert_array_equal(sum(r[f"kept/{i}"] for r in mine), want[f"kept/{i}"],
                                      err_msg=f"{name} call {i}")


def _held(cfg, key, j, coords, shape):
    """(kind, index): the index into one layer of JAX's cache leaf ``key``
    (rows first) of what the rank at ``coords`` holds, and the kind of the
    tensor: ``kv`` (its kv heads), ``wkv`` (its heads), ``mamba`` (its
    channels), ``x_prev`` or ``enc`` (whole).  ``shape``: the mesh's (pod,
    data, model)."""
    r0, n = _rows(coords, shape)
    rows = slice(r0, r0 + n)
    m, mi = shape[2], int(coords[2])
    if key == "enc":
        return "enc", (rows,)
    # whisper's kv/{j}; a decoder's units/l{e}/{j}, element e of the unit
    kind = ("attn" if key.startswith("kv/")
            else layer_plan(cfg).unit[int(key.split("/")[1][1:])].kind)
    if kind == "attn":
        kv0, kv1 = kv_heads(cfg, m, mi)
        return "kv", (rows, slice(None), slice(kv0, kv1))
    if kind == "rwkv":
        if j != 1:
            return "x_prev", (rows,)
        h = local_heads(cfg, m)  # all of them where the axis does not divide them
        return "wkv", (rows, slice(mi * h, (mi + 1) * h) if h * m == rwkv_dims(cfg)[1] else
                       slice(None))
    c = local_channels(cfg, m)
    chans = slice(mi * c, (mi + 1) * c)
    return "mamba", (rows, slice(None), chans) if j == 0 else (rows, chans)


def _places(cfg):
    """(JAX key, stacked index or None, port place) of every cache tensor."""
    for key, places in cache_leaves(cfg).items():
        if key == "enc":
            yield key, None, "enc"
        elif isinstance(places, tuple):
            for u, (i, j) in enumerate(places):
                yield key, u, f"{i}/{j}"


@pytest.mark.parametrize("name", list(CASES))
def test_cache_matches_jax(runs, name):
    arch, (shape, axes), over = CASES[name]
    cfg = _cfg(arch, over)
    want, ranks = runs[name]
    for res in ranks:
        for key, u, place in _places(cfg):
            j = int(place.split("/")[1]) if u is not None else None
            _, index = _held(cfg, key, j, res["coords"], shape)
            for tag in ("prefill", "last"):
                leaf = want[f"cache/{tag}/{key}"]
                expect = (leaf if u is None else leaf[u])[index]
                got = res[f"cache/{tag}/{place}"]
                assert got.shape == expect.shape, (name, key, place, tag)
                np.testing.assert_allclose(got, expect, rtol=1e-5, atol=LOGIT_ATOL,
                                           err_msg=f"{name} {key} {place} {tag}")


@pytest.mark.parametrize("name", list(CASES))
def test_cache_bytes_against_cache_specs(runs, name):
    arch, (shape, axes), over = CASES[name]
    cfg = _cfg(arch, over)
    sizes = dict(zip(axes, shape))
    shapes = cache_shapes(cfg, BATCH, S_MAX)
    specs = cache_specs(shapes, mesh_layout(shape, axes), cfg)
    kinds = set()
    for res in runs[name][1]:
        coords = dict(zip(axes, (int(c) for c in res["coords"])))
        for key, u, place in _places(cfg):
            j = int(place.split("/")[1]) if u is not None else None
            kind, _ = _held(cfg, key, j, res["coords"], shape)
            kinds.add(kind)
            cut = [len(range(n)[sl]) for n, sl in
                   zip(shapes[key], spec_slice(specs[key], shapes[key], sizes, coords))]
            per_layer = int(np.prod(cut if u is None else cut[1:]))
            held = res[f"cache/last/{place}"].size
            assert held == MULTIPLES[name][kind] * per_layer, (name, key, place, kind, held,
                                                               per_layer)
    assert kinds == set(MULTIPLES[name]), (name, kinds)


@pytest.mark.parametrize("name", list(CASES))
def test_last_cache_reassembled_matches_jax(runs, name):
    """Every rank's pieces of the cache after the last step, put back in
    place, cover JAX's whole cache and equal it."""
    arch, (shape, _), over = CASES[name]
    cfg = _cfg(arch, over)
    want, ranks = runs[name]
    for key, u, place in _places(cfg):
        leaf = want[f"cache/last/{key}"]
        leaf = leaf if u is None else leaf[u]
        whole = np.full(leaf.shape, np.nan, np.float32)
        j = int(place.split("/")[1]) if u is not None else None
        for res in ranks:
            _, index = _held(cfg, key, j, res["coords"], shape)
            piece = res[f"cache/last/{place}"]
            seen = whole[index]
            # a piece that two ranks hold is the same on both
            same = np.isnan(seen) | np.isclose(seen, piece, rtol=0, atol=1e-6)
            assert same.all(), (name, key, place)
            whole[index] = piece
        assert not np.isnan(whole).any(), (name, key, place)
        np.testing.assert_allclose(whole, leaf, rtol=1e-5, atol=LOGIT_ATOL,
                                   err_msg=f"{name} {key} {place}")


def test_decode_traffic_below_one_table(runs):
    """A decode step moves the logits, not the table; jamba's Mamba mixers
    also gather ``x_proj``, ``dt_proj`` and ``A_log`` (small beside a
    prefill's activations; at the smoke widths beside the table too).  The
    cases of 2 heads over 4 ranks gather every weight of their mixes and
    attentions a step, and are left out."""
    for name, (arch, _, over) in CASES.items():
        if name in WHOLE_CASES:
            continue
        cfg = _cfg(arch, over)
        limit = cfg.vocab_size * cfg.d_model * 4
        if cfg.mamba is not None:
            d_in, n = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
            dt_rank = cfg.mamba.dt_rank or -(-cfg.d_model // 16)
            per_layer = d_in * (dt_rank + 2 * n) + dt_rank * d_in + d_in * n
            mamba = sum(s.kind == "mamba" for s in layer_plan(cfg).layers())
            limit += 4 * per_layer * mamba
        for res in runs[name][1]:
            calls, nbytes = res["comm/decode"]
            assert calls > 0 and 0 < nbytes < limit, (name, calls, nbytes, limit)


def test_serve_cli_model_axis_under_torchrun():
    sharded = _cli(["--arch", "rwkv6-1.6b", "--model", "2"], ranks=4)
    single = _cli(["--arch", "rwkv6-1.6b"])
    assert len(sharded) == 2 and "on mesh" in sharded[0]  # rank 0 alone prints
    assert sharded[1] == single[1]
