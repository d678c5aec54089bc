"""The port's sharded serving of rwkv6, jamba, whisper and internvl2 under
ZeRO-3 (``fsdp``) against JAX's, on the CPU.

* Prefill and 5 greedy decode steps on 4 gloo ranks
  (``tests/torch_dist_ranks.py``, serve tasks with ``fsdp``) against JAX's
  jitted sharded prefill and decode with ``param_specs(fsdp=True)``
  (``tests/jax_dist_reference.py``, serve cases with ``"fsdp": true``) on a
  forced 4-device host mesh, from the same weights and prompts: the smoke
  configs in fp32, batch 4, a prompt of 8 tokens and 6 new ones, at (pod,
  data, model) = (1, 4, 1) and (1, 2, 2); jamba with 2 and with 16
  experts.  Each rank holds its blocks of every weight and gathers each
  module's just before its use: the decoders' layers (rwkv6's and jamba's
  through ``DecoderLM``), whisper's encoder and decoder layers, LayerNorms
  and ``tok`` / ``pos`` tables, the VLM's projector and table.
* Each rank's logits within 2e-5 of JAX's rows; greedy tokens equal; each
  of jamba's MoE layers' top-k experts and kept picks equal (each DP rank
  routes its rows within the whole batch's capacity, ``"dp"`` in the
  cache).
* Each rank's cache after the prefill and after the last step against the
  part of JAX's cache it holds (``tests/test_torch_serve_mesh_tp_families.py``'s
  ``_held``: its rows over pod x data, and at model 2 its kv heads, WKV
  heads and Mamba channels; the token-shift states and whisper's ``enc``
  whole over ``model``), and its bytes against ``cache_specs``' block at
  the stated multiple: under ``fsdp`` the cache is cut over the rows
  alone, ``enc`` included, so at (1, 4, 1) every leaf is 1.00x; at (1, 2,
  2) as the model axis makes it (``x_prev`` and ``enc`` 2x).
* The serve command line's ``--fsdp`` under ``torch.distributed.run``
  prints the single-device command line's tokens for jamba.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.dist.sharding import cache_specs, spec_slice  # noqa: E402
from repro_torch.launch.mesh import mesh_layout  # noqa: E402
from repro_torch.models.convert import cache_shapes  # noqa: E402
from repro_torch.models.transformer import layer_plan  # noqa: E402
from tests.test_torch_serve_mesh import (BATCH, LOGIT_ATOL, NEW, S_MAX, _cfg, _cli,  # noqa: E402
                                         _rows)
from tests.test_torch_serve_mesh_tp_families import (_held, _places,  # noqa: E402
                                                     _write_inputs)
from tests.torch_dist_ranks import jax_process, run_ranks, wait_all  # noqa: E402

AXES = ("pod", "data", "model")
M141, M122 = [(1, 4, 1), AXES], [(1, 2, 2), AXES]
JAMBA = "jamba-1.5-large-398b"
ARCHS = {"rwkv": ("rwkv6-1.6b", {}), "jamba2": (JAMBA, {"moe": {"num_experts": 2}}),
         "jamba16": (JAMBA, {"moe": {"num_experts": 16}}),
         "whisper": ("whisper-small", {}), "internvl2": ("internvl2-1b", {})}
# name -> (arch, mesh, cfg overrides); the port's case and JAX's share the name
CASES = {f"{short}-fsdp-{''.join(map(str, m[0]))}": (arch, m, over)
         for short, (arch, over) in ARCHS.items() for m in (M141, M122)}
# each case's rank cache against cache_specs' block, by kind: rows only at
# (1, 4, 1); at (1, 2, 2) the model axis's multiples
# (tests/test_torch_serve_mesh_tp_families.py)
KINDS = {"rwkv": ("x_prev", "wkv"), "jamba2": ("kv", "mamba"), "jamba16": ("kv", "mamba"),
         "whisper": ("kv", "enc"), "internvl2": ("kv",)}
AT_122 = {"x_prev": 2, "enc": 2}


def _multiple(name, kind):
    return AT_122.get(kind, 1) if name.endswith("-122") else 1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_mesh_fsdp"))
    sv = dict(fsdp=True, max_new=NEW, s_max=S_MAX)
    cases = [dict(name=n, arch=a, mesh=m, cfg=over, serve=sv,
                  **dict(zip(("init", "inputs"), _write_inputs(d, n, _cfg(a, over)))))
             for n, (a, m, over) in CASES.items()]
    procs = [jax_process({"devices": 4, "out": d, "cases": cases[i::2]},
                         os.path.join(d, f"jax{i}.json")) for i in range(2)]
    try:
        run_ranks({"world": 4, "store": os.path.join(d, "store"), "out": d, "tasks": cases},
                  os.path.join(d, "ranks.json"), timeout=600)
    finally:
        wait_all(procs, 600)
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
    expert kept over the whole batch, from the ranks at model coordinate 0
    in row order."""
    want, ranks = runs[name]
    arch, (shape, _), over = CASES[name]
    calls = len([k for k in want if k.startswith("routing/")])
    moe_layers = sum(s.moe for s in layer_plan(_cfg(arch, over)).layers())
    assert calls == NEW * moe_layers > 0
    mine = sorted((r for r in ranks if r["coords"][2] == 0),
                  key=lambda r: _rows(r["coords"], shape)[0])
    for i in range(calls):
        np.testing.assert_array_equal(np.concatenate([r[f"routing/{i}"] for r in mine]),
                                      want[f"routing/{i}"], err_msg=f"{name} call {i}")
        np.testing.assert_array_equal(sum(r[f"kept/{i}"] for r in mine), want[f"kept/{i}"],
                                      err_msg=f"{name} call {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_cache_matches_jax(runs, name):
    arch, (shape, _), over = CASES[name]
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
            assert held == _multiple(name, kind) * per_layer, (name, key, place, kind, held,
                                                               per_layer)
    assert kinds == set(KINDS[name.split("-")[0]]), (name, kinds)


def test_serve_cli_fsdp_under_torchrun():
    sharded = _cli(["--arch", JAMBA, "--fsdp"], ranks=4)
    single = _cli(["--arch", JAMBA])
    assert len(sharded) == 2 and "on mesh" in sharded[0]  # rank 0 alone prints
    assert sharded[1] == single[1]
