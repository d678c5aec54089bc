"""The port's distributed train steps at a ``model`` axis above 1 — tensor
and expert parallelism — against JAX's, on the CPU.

* One step of the flat and the hierarchical steps on 4 gloo ranks
  (``tests/torch_dist_ranks.py``) against JAX's ``make_train_step`` on a
  forced 4-device host mesh (``tests/jax_dist_reference.py``, its own
  process), from the same weights and the same global batch, at
  (pod, data, model) = (1, 2, 2), (1, 1, 4) and (2, 1, 2):
  qwen2.5-14b's smoke config (heads aligned at model 2; at model 4 its 2 kv
  heads of 16 are cut in pieces of 8 inside ``head_dim``, so ``wk``/``wv``
  are gathered), gemma-2b's (one kv head; tied embeddings, so the
  vocabulary-parallel loss gathers ``embed/tok``), deepseek-v3's (MLA; 2
  or 1 experts a rank) and grok-1's (softcap; 2 experts a rank), with
  ZeRO-1, ``compress`` across 2 pods and ``grad_accum`` 2.  The loss and
  grad norm within ``rel=1e-4``, every parameter within ``atol=3e-5``, and
  each rank's moment shard against JAX's shard at the same (pod, data,
  model) coordinates.  With ``compress`` across 2 pods an entry that meets
  a tie of the int8 quantizer is held to the looser bounds of
  ``tests/test_torch_dist.py``.  So is an entry whose clipped gradient
  (JAX's m / (1 - beta1)) is below 10 x AdamW's eps: the first update
  there is g / (|g| + eps), which moves by up to lr when g moves by its
  rounding (qwen2.5-14b at (1, 1, 4): one entry of ``wv`` with g = 7.8e-9,
  1e-6 of the leaf's largest, where the single-device port itself differs
  from JAX's step at that mesh by 3.2e-5).  deepseek-v3's flat step runs at data 1,
  where the port's per-rank routing is JAX's global routing.
* Each rank holds only its ``param_pspec`` slice of every leaf: the shapes
  and the number of parameter elements of a rank at (1, 1, 4).
* The step's ``comm`` counts the model axis's traffic.
* ``fsdp`` with the hierarchical step across pods raises naming C.9.

rwkv6, whisper and internvl2 at ``model`` > 1 are in
``tests/test_torch_tp_families.py``, through this file's helpers.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.dist import sharding as jsharding  # noqa: E402
from repro_torch.launch.mesh import mesh_layout  # noqa: E402
from repro_torch.models import get_api, smoke_config  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainstep import TrainHparams, make_train_step  # noqa: E402
from tests.test_torch_dist import OPT, TIE_MARGIN  # noqa: E402
from tests.torch_dist_ranks import jax_process, run_ranks, wait_all, write_inputs  # noqa: E402

AXES = ("pod", "data", "model")
M122, M114, M212 = [(1, 2, 2), AXES], [(1, 1, 4), AXES], [(2, 1, 2), AXES]
QWEN, GEMMA, DEEPSEEK, GROK = "qwen2.5-14b", "gemma-2b", "deepseek-v3-671b", "grok-1-314b"
# name -> (arch, mesh, hierarchical, compress, grad_accum); the port's case
# and JAX's share the name
CASES = {
    "qwen-flat-122": (QWEN, M122, False, False, 1),
    "qwen-flat-114-ga2": (QWEN, M114, False, False, 2),
    "gemma-hier-122": (GEMMA, M122, True, False, 1),
    "deepseek-hier-122": (DEEPSEEK, M122, True, False, 1),
    "deepseek-flat-114": (DEEPSEEK, M114, False, False, 1),
    "grok-hier-compress-212": (GROK, M212, True, True, 1),
}


def _hp(hier, compress, ga):
    return dict(hierarchical=hier, compress=compress, zero1=True, grad_accum=ga)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_steps(str(tmp_path_factory.mktemp("tp")), CASES)


def run_steps(d, cases_by_name):
    """One step of each case (name -> (arch, mesh, hierarchical, compress,
    grad_accum)) on 4 gloo ranks and in JAX, their results in ``d``."""
    inputs = {a: write_inputs(d, a) for a in sorted({c[0] for c in cases_by_name.values()})}
    cases = [dict(name=n, arch=a, mesh=m, hp=_hp(h, c, ga), opt=OPT, init=inputs[a],
                  batches=inputs[a], steps=1)
             for n, (a, m, h, c, ga) in cases_by_name.items()]
    # two JAX processes beside the ranks: each compiles half of the steps
    procs = [jax_process({"devices": 4, "out": d, "cases": cases[i::2]},
                         os.path.join(d, f"jax{i}.json")) for i in range(2)]
    try:
        run_ranks({"world": 4, "store": os.path.join(d, "store"), "out": d,
                   "tasks": [dict(c, ties=TIE_MARGIN) for c in cases]},
                  os.path.join(d, "ranks.json"))
    finally:
        wait_all(procs, 300)
    return d


def _index(key, shape, coords, arch, hier):
    """The index in JAX leaf ``key`` (global ``shape``) of the moment shard
    of the rank at ``coords`` (pod, data, model): its model slice along
    ``param_pspec``'s dim, cut over data along ``zero1_dim``'s."""
    _, data, model = coords[1]
    pod_i, data_i, model_i = coords[0]
    is_moe = smoke_config(arch).moe is not None
    index = [slice(None)] * len(shape)
    for d, a in enumerate(jsharding.param_pspec(key, shape, model, is_moe)):
        if a == "model":
            n = shape[d] // model
            index[d] = slice(model_i * n, (model_i + 1) * n)
    d = jsharding.zero1_dim(key, shape, model, data, is_moe)
    if d is not None:
        n = shape[d] // data
        index[d] = slice(data_i * n, (data_i + 1) * n)
    return tuple(index)


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax(runs, name):
    check_step(runs, name, CASES[name])


def check_step(runs, name, case):
    """The step of ``case`` (a ``CASES`` entry) on every rank against JAX's
    (module docstring)."""
    arch, (shape, axes), hier, compress, ga = case
    ranks = [np.load(os.path.join(runs, f"{name}.rank{r}.npz")) for r in range(4)]
    ref = np.load(os.path.join(runs, f"{name}.jax.npz"))
    assert sorted(ref["device_ids"]) == list(range(4))
    for r, res in enumerate(ranks):  # row-major, as JAX's mesh.devices
        assert tuple(res["coords"]) == tuple(np.unravel_index(r, shape))
        assert ref["device_ids"][r] == r
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_array_equal(res[k], ranks[0][k])
    np.testing.assert_allclose(ranks[0]["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["grad_norm"], ref["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["lr"], ref["lr"], rtol=1e-6)
    lr = float(ranks[0]["lr"][0])
    b1, b2 = OptConfig().beta1, OptConfig().beta2
    keys = [k[len("params/"):] for k in ranks[0].files if k.startswith("params/")]
    assert keys == [k[len("params/"):] for k in ref.files if k.startswith("params/")]
    pods, n_dp = shape[0], shape[0] * shape[1]
    near, moved, total, steep_n = 0, 0, 0, 0
    for key in keys:
        want = ref[f"params/{key}"]
        ties = np.zeros(want.shape, bool)
        quantum = np.zeros(want.shape, np.float32)  # of the averaged gradient, per entry
        m_jax = np.zeros(want.shape, np.float32)
        index = [_index(key, want.shape, (tuple(res["coords"]), shape), arch, hier)
                 for res in ranks]
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res[f"params/{key}"], ranks[0][f"params/{key}"])
            m_jax[index[r]] = ref[f"m/{r}/{key}"]
            if f"ties/{key}" in res.files:
                ties[index[r]] |= res[f"ties/{key}"]
                quantum[index[r]] = res[f"scale/{key}"] / 127.0 / n_dp
        steep = np.abs(m_jax) / (1 - b1) < 10 * OptConfig().eps
        got = ranks[0][f"params/{key}"]
        err = np.abs(got - want)
        loose = ties | steep
        assert np.all(err[~loose] <= 3e-5), (key, err[~loose].max())
        assert np.all(err[loose] <= lr + 3e-5), (key, err[loose].max())
        near, moved, total = near + ties.sum(), moved + (err[ties] > 3e-5).sum(), total + err.size
        steep_n += int((steep & (err > 3e-5)).sum())
        for g in ("m", "v"):  # each rank's shard against JAX's at its coordinates
            for r, res in enumerate(ranks):
                mine, theirs = res[f"{g}/{key}"], ref[f"{g}/{r}/{key}"]
                assert mine.shape == theirs.shape == want[index[r]].shape, (g, key, r)
                t, q = ties[index[r]], pods * quantum[index[r]]
                tol = 1e-4 * np.abs(theirs).max() + 1e-4 * np.abs(theirs)
                if g == "m":
                    loose = (1 - b1) * q * (1 + 1e-4)
                else:
                    loose = (1 - b2) * q * (2 * np.abs(ref[f"m/{r}/{key}"]) / (1 - b1) + q)
                diff = np.abs(mine - theirs)
                assert np.all(diff <= tol + np.where(t, loose, 0)), (g, key, r, diff.max())
    print(f"{name}: {steep_n} parameters with |g| < 10 eps differ from JAX by more than 3e-5")
    if compress and pods > 1:
        print(f"{name}: {near} of {total} parameters met a quantizer tie within {TIE_MARGIN}; "
              f"{moved} of them differ from JAX by more than 3e-5 (at most lr = {lr:g})")
    else:
        assert near == 0


@pytest.mark.parametrize("name", ["qwen-flat-114-ga2", "deepseek-flat-114"])
def test_rank_holds_its_pspec_slices(runs, name):
    check_slices(runs, name, CASES[name])


def check_slices(runs, name, case):
    """Each rank of ``case`` holds exactly its ``param_pspec`` slices."""
    arch, (shape, _), *_ = case
    is_moe = smoke_config(arch).moe is not None
    ref = np.load(os.path.join(runs, f"{name}.jax.npz"))
    for r in range(4):
        res = np.load(os.path.join(runs, f"{name}.rank{r}.npz"))
        total = cut = 0
        for f in (f for f in ref.files if f.startswith("params/")):
            key, whole = f[len("params/"):], ref[f].shape
            spec = jsharding.param_pspec(key, whole, shape[2], is_moe)
            want = tuple(n // shape[2] if a == "model" else n for n, a in zip(whole, spec))
            assert tuple(res[f"local/{key}"]) == want, key
            total += int(np.prod(want))
            cut += want != whole
        assert int(res["numel"]) == total
        assert cut > len([f for f in ref.files if f.startswith("params/")]) // 2


def test_comm_counts_the_model_axis(runs):
    for name, (arch, (shape, _), hier, *_) in CASES.items():
        res = np.load(os.path.join(runs, f"{name}.rank0.npz"))
        calls, nbytes = res["comm/model"]
        assert calls > 0 and nbytes > 0, name
        # the hierarchical step sums over pod, of size 1 or 2
        assert ("comm/pod" in res.files) == hier, name


def test_fsdp_still_raises():
    """ZeRO-3 composes with the model axis (the hierarchical step at
    (1, 2, 2) is held against JAX's in tests/test_torch_fsdp.py); it still
    raises for the hierarchical step across pods (ROADMAP C.9), and the
    step refuses an api built without the blocks.  Every family builds
    them (tests/test_torch_fsdp_families.py)."""
    cfg = smoke_config(QWEN)
    with pytest.raises(NotImplementedError, match=r"ROADMAP C\.9"):
        make_train_step(get_api(cfg, device="cpu"), cfg, OptConfig(), mesh_layout((2, 1, 2), AXES),
                        TrainHparams(hierarchical=True, fsdp=True), {"tokens": (8, 16)})
    with pytest.raises(ValueError, match=r"fsdp=True"):  # the api must hold the blocks
        make_train_step(get_api(cfg, device="cpu"), cfg, OptConfig(), mesh_layout((1, 4, 1), AXES),
                        TrainHparams(hierarchical=True, fsdp=True), {"tokens": (8, 16)})
