"""The port's distributed train steps over the data axes against JAX's, on
the CPU.

* The sharding rules (``repro_torch.dist.sharding``, ZeRO-3's
  ``param_specs(fsdp=True)`` too) against JAX's for all 10 architectures
  at full size, on JAX's stacked shapes
  (``jax.eval_shape`` of ``api.init``), with stub meshes (2, 2, 1),
  (1, 4, 1) and (2, 2, 2) over (pod, data, model).
* One step of the flat and the hierarchical steps on 4 gloo ranks
  (``tests/torch_dist_ranks.py``) against JAX's ``make_train_step`` on a
  forced 4-device host mesh (``tests/jax_dist_reference.py``, its own
  process: ``XLA_FLAGS`` must be set before jax is imported), both from the
  same weights and the same global batch: olmo-1b's and deepseek-v3's smoke
  configs, at (pod, data, model) = (2, 2, 1) and (data, model) = (4, 1),
  with ZeRO-1, with and without ``compress``, at ``grad_accum`` 1 and 2.
  The loss and grad norm within ``rel=1e-4``, every parameter within
  ``atol=3e-5`` (as JAX's own hierarchical-vs-pjit test,
  ``tests/test_trainstep.py``), and each rank's moment shard against JAX's
  shard at the same mesh coordinates.
* deepseek-v3's flat step is held against JAX's hierarchical step: the
  port's ranks route their own tokens through the MoE (capacity and aux
  loss per rank), as JAX's hierarchical step does, where JAX's flat step
  routes the global batch as one under GSPMD.
* With ``compress`` across 2 pods, a gradient that lands on a tie of the
  int8 quantizer (round(x) with x = gs / scale * 127 within ``TIE_MARGIN``
  of k + 1/2) may round the other way in the other stack, and AdamW's first
  update there moves by up to the step's lr instead of 3e-5.  The ranks
  record those entries as the quantizer meets them; only they are held to
  the looser bounds (lr + 3e-5 on the parameter, the moments' change of one
  quantum per pod), and the test prints how many there were and how many
  of them differ beyond 3e-5.
"""
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import sharding as jsharding  # noqa: E402
from repro.models import get_api as jget_api  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch.mesh import make_mesh, mesh_layout  # noqa: E402
from repro_torch.models import get_api, smoke_config  # noqa: E402
from repro_torch.models.convert import jax_leaves  # noqa: E402
from repro_torch.models.registry import model_class  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainstep import TrainHparams, make_train_step, quantize_int8  # noqa: E402
from tests.torch_dist_ranks import jax_process, run_ranks, wait_all, write_inputs  # noqa: E402

MESHES = [((2, 2, 1), ("pod", "data", "model")), ((1, 4, 1), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


class _StubMesh:
    """What JAX's rules read of a mesh: axis names and a devices array."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


def _flat(tree):
    return {jsharding._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))[0]}


_TREES = {}


def _trees(arch):
    """(JAX cfg, JAX's abstract params, port cfg, port's stacked shapes)."""
    if arch not in _TREES:
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        jtree = jax.eval_shape(jget_api(jcfg).init, jax.random.PRNGKey(0))
        named = dict(model_class(cfg)(cfg, torch.device("meta")).named_parameters())
        shapes = {k: (len(n),) + tuple(named[n[0]].shape) if isinstance(n, tuple)
                  else tuple(named[n].shape) for k, n in jax_leaves(named, cfg).items()}
        _TREES[arch] = jcfg, jtree, cfg, shapes
    return _TREES[arch]


@pytest.mark.parametrize("shape,axes", MESHES, ids=["221", "141", "222"])
@pytest.mark.parametrize("arch", sorted(configs.ARCH_IDS))
def test_sharding_rules_match_jax(arch, shape, axes):
    jcfg, jtree, cfg, shapes = _trees(arch)
    jshapes = {k: tuple(leaf.shape) for k, leaf in _flat(jtree).items()}
    assert list(shapes.items()) == list(jshapes.items())  # keys, order and stacked shapes
    stub, mesh = _StubMesh(shape, axes), mesh_layout(shape, axes)
    sizes = dict(zip(axes, shape))
    as_tuples = lambda tree: {k: tuple(s) for k, s in _flat(tree).items()}  # noqa: E731
    assert sharding.param_specs(shapes, mesh, cfg) == as_tuples(
        jsharding.param_specs(jtree, stub, jcfg))
    for use_pod in (False, True):
        assert sharding.zero1_specs(shapes, mesh, cfg, use_pod=use_pod) == as_tuples(
            jsharding.zero1_specs(jtree, stub, jcfg, use_pod=use_pod))
    is_moe = cfg.moe is not None
    for key, s in shapes.items():
        assert sharding.param_pspec(key, s, sizes["model"], is_moe) == tuple(
            jsharding.param_pspec(key, s, sizes["model"], is_moe)), key
        for data in (sizes["data"], 3, 1):
            assert sharding.zero1_dim(key, s, sizes["model"], data, is_moe) == \
                jsharding.zero1_dim(key, s, sizes["model"], data, is_moe), (key, data)
    batch = {"tokens": np.zeros((8, 16), np.int32), "frames": np.zeros((8, 4, 2), np.float32),
             "odd": np.zeros((6, 3), np.int32), "scalar": np.zeros((), np.float32)}
    assert sharding.batch_specs(batch, mesh) == {
        k: tuple(s) for k, s in jsharding.batch_specs(batch, stub).items()}
    fsdp_specs = as_tuples(jsharding.param_specs(jtree, stub, jcfg, fsdp=True))
    assert sharding.param_specs(shapes, mesh, cfg, fsdp=True) == fsdp_specs
    # each DP index's block inside its model slice, where JAX's ZeRO-3 spec
    # puts ("pod", "data")
    n_dp = sizes["pod"] * sizes["data"]
    for key, s in shapes.items():
        local = sharding.local_shape(key, s, sizes, cfg.moe is not None)
        for b in range(n_dp):
            want = tuple(slice(b * (n // n_dp), (b + 1) * (n // n_dp)) if a == ("pod", "data")
                         else slice(None) for n, a in zip(local, fsdp_specs[key]))
            assert sharding.fsdp_slice(key, s, sizes["model"], n_dp, b,
                                       cfg.moe is not None) == want, (key, b)


_CACHES = {}


@pytest.mark.parametrize("seq_shard", [False, True], ids=["rows", "seq"])
@pytest.mark.parametrize("shape,axes", MESHES + [((1, 1, 4), ("pod", "data", "model")),
                                                 ((2, 1, 2), ("pod", "data", "model"))],
                         ids=["221", "141", "222", "114", "212"])
@pytest.mark.parametrize("arch", sorted(configs.ARCH_IDS))
def test_cache_specs_match_jax(arch, shape, axes, seq_shard):
    """The serving cache's rules on the shapes of JAX's ``init_cache`` (batch
    8, 32 slots), and the port's per-layer cache map reaches every JAX leaf
    once, each layer's tensor at its place in the stacked leaf."""
    from repro_torch.models.convert import cache_leaves, cache_shapes
    from repro_torch.models.registry import init_cache

    if arch not in _CACHES:
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        jtree = jax.eval_shape(lambda: jget_api(jcfg).init_cache(8, 32))
        _CACHES[arch] = jcfg, jtree, cfg
    jcfg, jtree, cfg = _CACHES[arch]
    shapes = cache_shapes(cfg, 8, 32)
    assert shapes == {k: tuple(leaf.shape) for k, leaf in _flat(jtree).items()}
    assert list(shapes) == list(_flat(jtree))
    stub, mesh = _StubMesh(shape, axes), mesh_layout(shape, axes)
    assert sharding.cache_specs(shapes, mesh, cfg, seq_shard=seq_shard) == {
        k: tuple(s) for k, s in _flat(jsharding.cache_specs(
            jtree, stub, jcfg, seq_shard=seq_shard)).items()}
    # every port tensor lands once, and at the stacked leaf's per-layer shape
    port = init_cache(cfg, 8, 32, "meta")
    places = [p for v in cache_leaves(cfg).values() for p in (v if isinstance(v, tuple) else [v])]
    want = [(i, j) for i, entry in enumerate(port["layers"]) for j in range(len(entry))]
    assert sorted(p for p in places if isinstance(p, tuple)) == want
    assert sorted(p for p in places if isinstance(p, str)) == sorted(
        k for k in port if k != "layers")
    for key, v in cache_leaves(cfg).items():
        for i, j in (v if isinstance(v, tuple) else ()):
            assert tuple(port["layers"][i][j].shape) == shapes[key][1:], (key, i, j)


# a model axis above 1 trains every family (tests/test_torch_tp.py,
# tests/test_torch_tp_families.py); the hierarchical step with fsdp across
# pods fails in JAX (C.9)
@pytest.mark.parametrize("shape,axes,hp,arch,item", [
    ((2, 2, 1), ("pod", "data", "model"), TrainHparams(hierarchical=True, fsdp=True),
     "olmo-1b", "C.9"),
], ids=["fsdp"])
def test_model_axis_and_fsdp_raise(shape, axes, hp, arch, item):
    cfg = smoke_config(arch)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP {re.escape(item)}\b"):
        make_train_step(get_api(cfg, device="cpu"), cfg, OptConfig(), mesh_layout(shape, axes),
                        hp, {"tokens": (8, 16)})


def test_cuda_mesh_does_not_fall_back():
    """No NCCL or no card for the rank: a cuda mesh raises, never runs on
    the CPU or over gloo."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="NCCL"):
        make_mesh((1, 1, 1), ("pod", "data", "model"), device="cuda")


def test_quantizer_rounds_half_to_even_as_jax():
    gs = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 200.0, -300.0, 0.49999997]) / 127.0
    scale = torch.tensor(1.0)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(gs.numpy()) / 1.0 * 127.0), -127, 127))
    got = quantize_int8(gs, scale)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:5], [0, 2, 2, 0, -2])


# ---------------------------------------------------------------------------
# one step on 4 gloo ranks against JAX on a forced 4-device mesh
# ---------------------------------------------------------------------------

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
POD = [(2, 2, 1), ("pod", "data", "model")]
DATA = [(4, 1), ("data", "model")]
TIE_MARGIN = 1e-3  # |x - (k + 1/2)| in units of the quantizer's step
# JAX cases: name -> (arch, mesh, hierarchical, compress, grad_accum)
JAX_CASES = {
    "olmo-pjit-pod-ga1": ("olmo-1b", POD, False, False, 1),
    "olmo-hier-pod-ga1": ("olmo-1b", POD, True, False, 1),
    "olmo-hier-compress-pod-ga2": ("olmo-1b", POD, True, True, 2),
    "olmo-pjit-data-ga2": ("olmo-1b", DATA, False, False, 2),
    "olmo-hier-compress-data-ga1": ("olmo-1b", DATA, True, True, 1),
    "deepseek-hier-compress-pod-ga1": ("deepseek-v3-671b", POD, True, True, 1),
    "deepseek-hier-data-ga2": ("deepseek-v3-671b", DATA, True, False, 2),
}
# the port's cases: (name, arch, mesh, hierarchical, compress, grad_accum, JAX case)
CASES = [
    ("olmo-flat-pod-ga1", "olmo-1b", POD, False, False, 1, "olmo-pjit-pod-ga1"),
    ("olmo-hier-pod-ga1", "olmo-1b", POD, True, False, 1, "olmo-hier-pod-ga1"),
    ("olmo-hier-compress-pod-ga2", "olmo-1b", POD, True, True, 2, "olmo-hier-compress-pod-ga2"),
    ("olmo-flat-data-ga2", "olmo-1b", DATA, False, False, 2, "olmo-pjit-data-ga2"),
    ("olmo-hier-compress-data-ga1", "olmo-1b", DATA, True, True, 1,
     "olmo-hier-compress-data-ga1"),
    ("deepseek-hier-compress-pod-ga1", "deepseek-v3-671b", POD, True, True, 1,
     "deepseek-hier-compress-pod-ga1"),
    ("deepseek-hier-data-ga2", "deepseek-v3-671b", DATA, True, False, 2,
     "deepseek-hier-data-ga2"),
    ("deepseek-flat-data-ga2", "deepseek-v3-671b", DATA, False, False, 2,
     "deepseek-hier-data-ga2"),
]


def _hp(hier, compress, ga):
    return dict(hierarchical=hier, compress=compress, zero1=True, grad_accum=ga)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    inputs = {a: write_inputs(d, a) for a in ("olmo-1b", "deepseek-v3-671b")}
    procs = []
    for arch in inputs:  # one JAX process per arch, side by side
        cases = [dict(name=n, arch=a, mesh=m, hp=_hp(h, c, ga), opt=OPT, init=inputs[a],
                      batches=inputs[a], steps=1)
                 for n, (a, m, h, c, ga) in JAX_CASES.items() if a == arch]
        procs.append(jax_process({"devices": 4, "out": d, "cases": cases},
                                 os.path.join(d, f"jax-{arch}.json")))
    tasks = [dict(name=n, arch=a, mesh=m, hp=_hp(h, c, ga), opt=OPT, init=inputs[a],
                  batches=inputs[a], steps=1, ties=TIE_MARGIN)
             for n, a, m, h, c, ga, _ in CASES]
    try:
        run_ranks({"world": 4, "store": os.path.join(d, "store"), "out": d, "tasks": tasks},
                  os.path.join(d, "ranks.json"))
    finally:
        wait_all(procs, 300)
    return d


def _block(shard_shape, full_shape, idx):
    """The index of block ``idx`` of a shard of ``shard_shape`` in a leaf
    of ``full_shape`` (the shard is cut along the one dim that differs)."""
    return tuple(slice(idx * a, (idx + 1) * a) if a != b else slice(None)
                 for a, b in zip(shard_shape, full_shape))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_step_matches_jax(runs, case):
    name, arch, (shape, axes), hier, compress, ga, jax_name = case
    ranks = [np.load(os.path.join(runs, f"{name}.rank{r}.npz")) for r in range(4)]
    ref = np.load(os.path.join(runs, f"{jax_name}.jax.npz"))
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
    pods = shape[0] if axes[0] == "pod" else 1
    data_idx = lambda res: res["coords"][axes.index("data")]  # noqa: E731
    near, moved, total = 0, 0, 0
    for key in keys:
        want = ref[f"params/{key}"]
        ties = np.zeros(want.shape, bool)
        quantum = np.zeros(want.shape, np.float32)  # of the averaged gradient, per entry
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res[f"params/{key}"], ranks[0][f"params/{key}"])
            if f"ties/{key}" in res.files:
                index = _block(res[f"ties/{key}"].shape, want.shape, data_idx(res))
                ties[index] |= res[f"ties/{key}"]
                quantum[index] = res[f"scale/{key}"] / 127.0 / np.prod(shape)
        got = ranks[0][f"params/{key}"]
        err = np.abs(got - want)
        assert np.all(err[~ties] <= 3e-5), (key, err[~ties].max())
        assert np.all(err[ties] <= lr + 3e-5), (key, err[ties].max())
        near, moved, total = near + ties.sum(), moved + (err[ties] > 3e-5).sum(), total + err.size
        for g in ("m", "v"):  # each rank's shard against JAX's at its coordinates
            for r, res in enumerate(ranks):
                mine, theirs = res[f"{g}/{key}"], ref[f"{g}/{r}/{key}"]
                assert mine.shape == theirs.shape, (g, key, r)
                index = _block(mine.shape, want.shape, data_idx(res))
                t, q = ties[index], pods * quantum[index]
                tol = 1e-4 * np.abs(theirs).max() + 1e-4 * np.abs(theirs)
                if g == "m":
                    loose = (1 - b1) * q * (1 + 1e-4)
                else:
                    loose = (1 - b2) * q * (2 * np.abs(ref[f"m/{r}/{key}"]) / (1 - b1) + q)
                diff = np.abs(mine - theirs)
                assert np.all(diff <= tol + np.where(t, loose, 0)), (g, key, r, diff.max())
    if compress and pods > 1:
        print(f"{name}: {near} of {total} parameters met a quantizer tie within {TIE_MARGIN}; "
              f"{moved} of them differ from JAX by more than 3e-5 (at most lr = {lr:g})")
    else:
        assert near == 0
