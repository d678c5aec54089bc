"""The port's sharded serving against JAX's, on the CPU.

* Prefill and greedy decode on 4 gloo ranks (``tests/torch_dist_ranks.py``,
  serve tasks) against JAX's ``jax.jit(api.prefill / api.decode,
  in_shardings=...)`` with ``param_specs``, ``batch_specs`` and
  ``cache_specs``, as ``launch/dryrun.py`` builds them, on a forced
  4-device host mesh (``tests/jax_dist_reference.py``, serve cases), from
  the same weights and prompts: smoke configs in fp32, batch 4, a prompt of
  8 tokens and 6 new ones.  Cases: qwen2.5-14b at (pod, data, model) =
  (1, 2, 2) and (1, 1, 4) (its 2 kv heads cut inside ``head_dim`` by
  ``cache_specs`` at model 4), gemma-2b at (1, 1, 4) (one kv head; the
  tied table cut along d), deepseek-v3 at (1, 2, 2) (MLA's absorbed decode,
  expert parallelism), grok-1 at (2, 1, 2) (softcap, experts across pods)
  and again with capacity factor 0.5, which drops picks (each DP rank
  routes its rows within the whole batch's capacity) and at a batch of 1
  with capacity factor 0.5 (the DP ranks do not divide the batch: each
  holds the whole batch and routes it alone, as JAX does on a replicated
  batch), gemma2-9b with ``fsdp`` at (1, 4, 1) and (1, 2, 2), and rwkv6,
  jamba, whisper and internvl2 at (1, 4, 1) (rows only: every family
  serves over the DP axes).
* Each rank's logits within 2e-5 of JAX's rows (JAX's own sharded and
  whole runs differ by up to 7.1e-6); greedy tokens equal exactly; each MoE
  layer's top-k experts of every token equal, and the picks each expert
  kept summed over the DP ranks equal; each rank's cache equal to its
  slice of JAX's cache (``dist.sharding.spec_slice``) where
  ``cache_specs`` cuts whole kv heads or rows, else to the rows and kv
  heads it reads (a kv head cut inside ``head_dim``, MLA's latents cut
  along the sequence, held whole).
* ``comm_profile()`` at every mesh equals the single-device engine's; a
  decode step's ``comm["model"]`` bytes stay below one unembedding
  table's: the logits move, not the table.
* rwkv6, jamba, whisper and internvl2 under ``fsdp`` are held against
  JAX's in ``tests/test_torch_serve_mesh_fsdp_families.py``, their model
  axis in ``tests/test_torch_serve_mesh_tp_families.py``.
* The serve CLI under ``torch.distributed.run`` with ``--model 2`` and with
  ``--fsdp`` prints the single-device CLI's tokens.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.dist.sharding import cache_specs, dp_index, spec_slice  # noqa: E402
from repro_torch.launch.mesh import mesh_layout  # noqa: E402
from repro_torch.models import get_api, modality_inputs, smoke_config  # noqa: E402
from repro_torch.models.attention import kv_heads  # noqa: E402
from repro_torch.models.convert import cache_leaves, cache_shapes, params_to_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from tests.torch_dist_ranks import REPO, jax_process, run_ranks, wait_all  # noqa: E402

AXES = ("pod", "data", "model")
M122, M114, M212, M141 = [(1, 2, 2), AXES], [(1, 1, 4), AXES], [(2, 1, 2), AXES], \
    [(1, 4, 1), AXES]
BATCH, PROMPT, NEW = 4, 8, 6
S_MAX = PROMPT + NEW
DROPS = {"moe": {"capacity_factor": 0.5}}
# name -> (arch, mesh, fsdp, cfg overrides); the port's case and JAX's share the name
CASES = {
    "qwen-122": ("qwen2.5-14b", M122, False, {}),
    "qwen-114": ("qwen2.5-14b", M114, False, {}),
    "gemma-114": ("gemma-2b", M114, False, {}),
    "deepseek-122": ("deepseek-v3-671b", M122, False, {}),
    "grok-212": ("grok-1-314b", M212, False, {}),
    "grok-212-drops": ("grok-1-314b", M212, False, DROPS),
    "grok-212-b1-drops": ("grok-1-314b", M212, False, DROPS),
    "gemma2-fsdp-141": ("gemma2-9b", M141, True, {}),
    "gemma2-fsdp-122": ("gemma2-9b", M122, True, {}),
    "rwkv-141": ("rwkv6-1.6b", M141, False, {}),
    "jamba-141": ("jamba-1.5-large-398b", M141, False, {}),
    "whisper-141": ("whisper-small", M141, False, {}),
    "internvl2-141": ("internvl2-1b", M141, False, {}),
}
# the cases whose batch is not BATCH: the DP ranks do not divide it
BATCHES = {"grok-212-b1-drops": 1}
DROPPING = ("grok-212-drops", "grok-212-b1-drops")  # the cases whose routing drops picks
LOGIT_ATOL = 2e-5


def _cfg(arch, over):
    """The smoke config of ``arch`` with ``over``: a dict for a nested config."""
    import dataclasses

    cfg = smoke_config(arch)
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
                          else v for k, v in over.items()})


def _write_case_inputs(d, arch, batches):
    """The single-device port's ``init(0)`` weights as JAX's flat leaves,
    and the prompts of each batch size (a fixed generator), in
    ``{d}/{arch}.*.npz``: (weights, {batch: prompts})."""
    cfg = smoke_config(arch)
    model = get_api(cfg, device="cpu").init(0)
    init = os.path.join(d, f"{arch}.params.npz")
    np.savez(init, **{f"params/{k}": a for k, a in params_to_jax(model.state_dict(), cfg).items()})
    inputs = {}
    for b in batches:
        rng = np.random.default_rng(7)
        inputs[b] = os.path.join(d, f"{arch}.b{b}.inputs.npz")
        np.savez(inputs[b], tokens=rng.integers(0, cfg.vocab_size, size=(b, PROMPT)).astype(
            np.int64), **modality_inputs(cfg, rng, b))
    return init, inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_mesh"))
    batches = {}
    for n, c in CASES.items():
        batches.setdefault(c[0], set()).add(BATCHES.get(n, BATCH))
    files = {a: _write_case_inputs(d, a, sorted(b)) for a, b in batches.items()}
    sv = lambda fsdp: dict(fsdp=fsdp, max_new=NEW, s_max=S_MAX)  # noqa: E731
    cases = [dict(name=n, arch=a, mesh=m, cfg=over, serve=sv(f), init=files[a][0],
                  inputs=files[a][1][BATCHES.get(n, BATCH)])
             for n, (a, m, f, over) in CASES.items()]
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


def _rows(coords, shape, batch=BATCH):
    """(first row, rows) of the rank at ``coords`` on a mesh of ``shape``
    (pod, data, model): ``batch_specs``' cut of a batch of ``batch`` rows
    (every row where the DP ranks do not divide it)."""
    pod, data = shape[0], shape[1]
    if batch % (pod * data):
        return 0, batch
    n = batch // (pod * data)
    return dp_index(int(coords[0]), int(coords[1]), data) * n, n


@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_tokens_match_jax(runs, name):
    want, ranks = runs[name]
    for res in ranks:
        r0, n = _rows(res["coords"], CASES[name][1][0], BATCHES.get(name, BATCH))
        for i in range(NEW):
            got, ref = res[f"logits/{i}"], want[f"logits/{i}"][r0:r0 + n]
            err = np.abs(got - ref).max()
            assert err <= LOGIT_ATOL, (name, tuple(res["coords"]), i, err)
        np.testing.assert_array_equal(res["tokens"], want["tokens"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if smoke_config(c[0]).moe])
def test_routing_matches_jax(runs, name):
    """Each MoE layer's top-k experts of every token, and the picks each
    expert kept over the whole batch (the ranks at model coordinate 0, whose
    rows are the batch; where the DP ranks do not divide the batch, each of
    them alone)."""
    want, ranks = runs[name]
    shape, batch = CASES[name][1][0], BATCHES.get(name, BATCH)
    calls = len([k for k in want if k.startswith("routing/")])
    assert calls == NEW * sum(b for b in _moe_layers(CASES[name][0]))
    mine = sorted((r for r in ranks if r["coords"][2] == 0),
                  key=lambda r: _rows(r["coords"], shape, batch)[0])
    split = _rows(mine[0]["coords"], shape, batch)[1] < batch
    kept_any = False
    for group in [mine] if split else [[r] for r in mine]:
        for i in range(calls):
            idx = np.concatenate([r[f"routing/{i}"] for r in group])
            np.testing.assert_array_equal(idx, want[f"routing/{i}"], err_msg=f"{name} call {i}")
            kept = sum(r[f"kept/{i}"] for r in group)
            np.testing.assert_array_equal(kept, want[f"kept/{i}"], err_msg=f"{name} call {i}")
            kept_any |= kept.sum() < idx.size
    # the capacity cases drop picks; the others drop none
    assert kept_any == (name in DROPPING)


def _moe_layers(arch):
    from repro_torch.models.transformer import layer_plan

    return [s.moe for s in layer_plan(smoke_config(arch)).layers()]


@pytest.mark.parametrize("name", list(CASES))
def test_cache_matches_jax(runs, name):
    arch, (shape, axes), _, over = CASES[name]
    cfg, batch = _cfg(arch, over), BATCHES.get(name, BATCH)
    want, ranks = runs[name]
    sizes = dict(zip(axes, shape))
    shapes = cache_shapes(cfg, batch, S_MAX)
    specs = cache_specs(shapes, mesh_layout(shape, axes), cfg)
    sliced = 0
    for res in ranks:
        coords = dict(zip(axes, (int(c) for c in res["coords"])))
        r0, n = _rows(res["coords"], shape, batch)
        kv0, kv1 = kv_heads(cfg, sizes["model"], coords["model"])
        for key, places in cache_leaves(cfg).items():
            if not isinstance(places, tuple):
                continue
            spec = specs[key]
            for u, (i, j) in enumerate(places):
                for tag in ("prefill", "last"):
                    leaf, got = want[f"cache/{tag}/{key}"], res[f"cache/{tag}/{i}/{j}"]
                    if "model" not in spec or (len(spec) == 5 and spec[3] == "model"):
                        # rows only, or whole kv heads: the rank's slice of JAX's cache
                        expect = leaf[spec_slice(spec, leaf.shape, sizes, coords)][u]
                        sliced += 1
                    else:  # cut inside a kv head or along MLA's sequence: held whole
                        expect = leaf[u, r0:r0 + n]
                        if got.ndim == 4:  # GQA k or v: the kv heads the rank reads
                            expect = expect[:, :, kv0:kv1]
                    assert got.shape == expect.shape, (name, key, i, tag)
                    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=LOGIT_ATOL,
                                               err_msg=f"{name} {key} layer {i} {tag}")
    # gemma-2b's one kv head, qwen's 2 kv heads over 4 ranks and MLA's
    # latents are the cases held whole
    assert (sliced == 0) == (name in ("qwen-114", "gemma-114", "deepseek-122")), (name, sliced)


def test_comm_profile_and_decode_traffic(runs):
    """``comm_profile`` on every rank equals the single-device engine's;
    at model > 1 a decode step moves fewer bytes over ``model`` than one
    unembedding table holds."""
    for name, (arch, (shape, _), _, over) in CASES.items():
        cfg = _cfg(arch, over)
        api = get_api(cfg, device="cpu")
        prof = ServeEngine(api, None, batch=BATCHES.get(name, BATCH), s_max=S_MAX).comm_profile()
        want = np.asarray([prof[k] for k in sorted(prof)])
        table = cfg.vocab_size * cfg.d_model * 4
        for res in runs[name][1]:
            np.testing.assert_array_equal(res["profile"], want, err_msg=name)
            calls, nbytes = res["comm/decode"]
            if shape[2] > 1:
                assert 0 < nbytes < table, (name, nbytes, table)
            else:
                assert calls == 0, name


def _cli(argv, ranks=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    head = [sys.executable, "-m"]
    if ranks:
        head += ["torch.distributed.run", "--standalone", "--nproc-per-node", str(ranks), "-m"]
    res = subprocess.run(head + ["repro_torch.launch.serve", "--smoke", "--device", "cpu",
                                 "--batch", "4", "--prompt-len", "8", "--max-new", "6"] + argv,
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return re.findall(r"^(generated .*|first row: .*)$", res.stdout, re.M)


@pytest.mark.parametrize("arch,flags", [("qwen2.5-14b", ["--model", "2"]),
                                        ("gemma2-9b", ["--fsdp"])], ids=["model-2", "fsdp"])
def test_serve_cli_under_torchrun(arch, flags):
    sharded = _cli(["--arch", arch] + flags, ranks=4)
    single = _cli(["--arch", arch])
    assert len(sharded) == 2 and "on mesh" in sharded[0]  # rank 0 alone prints
    assert sharded[1] == single[1]
