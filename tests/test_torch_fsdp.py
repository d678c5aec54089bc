"""The port's ZeRO-3 (``fsdp``) train steps against JAX's, on the CPU.

* Two steps of the flat and the hierarchical steps with ``fsdp`` on 4 gloo
  ranks (``tests/torch_dist_ranks.py``) against JAX's ``make_train_step``
  with ``TrainHparams(fsdp=True)`` on a forced 4-device host mesh
  (``tests/jax_dist_reference.py``, one process for the file), from the
  same weights and the same global batches:
  gemma2-9b's smoke config flat at (pod, data, model) = (1, 4, 1),
  (2, 2, 1) and (1, 2, 2) (the leaves cut inside the layer, along
  ``d_model`` and the vocabulary, at data 4; along the stacked unit axis,
  a rank owning whole units, at data 2), olmo-1b's flat at (1, 4, 1) with
  ``grad_accum`` 2 (a rank owns one whole layer), deepseek-v3's flat at
  (1, 2, 2) (MLA and MoE, experts over ``model``), held against JAX's
  hierarchical step, which routes each rank's tokens apart as the port
  does, and gemma2-9b's hierarchical step at (1, 2, 2).  The loss, grad
  norm and lr of each step within ``rel=1e-4``; after the first step every
  parameter within ``atol=3e-5`` and the moments within the bounds of
  ``tests/test_torch_tp.py``, each rank's moment shard cut out of the
  port's whole moments at JAX's block for its mesh coordinates:
  ``("data", "pod")`` order, where the port keeps the moments in the
  parameters' ``("pod", "data")`` blocks; after the second, every
  parameter within ``AFTER_SECOND``.
* A rank holds only its blocks: every parameter's and moment's shape is
  the block ``param_specs(fsdp=True)`` gives, and the parameters' elements
  sum to the blocks'.
* The step's ``comm`` counts ZeRO-3's collectives under the DP group's
  name, their bytes equal to what the leaves imply.
* The hierarchical step with ``fsdp`` across pods raises naming ROADMAP
  C.9.

rwkv6, jamba, whisper and internvl2 under ``fsdp`` are in
``tests/test_torch_fsdp_families.py``, through this file's helpers.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.dist import sharding as jsharding  # noqa: E402
from repro_torch.dist.sharding import dp_index, moment_index  # noqa: E402
from repro_torch.launch.mesh import mesh_layout  # noqa: E402
from repro_torch.models import get_api, smoke_config  # noqa: E402
from repro_torch.models.convert import stacked_shapes  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainstep import TrainHparams, make_train_step  # noqa: E402
from tests.test_torch_dist import OPT  # noqa: E402
from tests.torch_dist_ranks import jax_process, run_ranks, wait_all, write_inputs  # noqa: E402

AXES = ("pod", "data", "model")
M141, M221, M122 = [(1, 4, 1), AXES], [(2, 2, 1), AXES], [(1, 2, 2), AXES]
GEMMA2, OLMO, DEEPSEEK = "gemma2-9b", "olmo-1b", "deepseek-v3-671b"
STEPS = 2
# The parameters after the second step, within lr / 10 of JAX's: that step's
# first moment can cancel (0.09 g0 + 0.1 g1 with g1 ~ -g0), and JAX's own
# FSDP step and its single-device step differ by 3.4e-5 there (gemma2-9b's
# smoke ``units/l0/mix/wv`` at (1, 4, 1), where the port's FSDP step is
# within 2.1e-6 of JAX's single-device one).  The first step is held to
# the bounds of tests/test_torch_dist.py and tests/test_torch_tp.py.
AFTER_SECOND = 1e-4
# JAX cases: name -> (arch, mesh, hierarchical, grad_accum)
JAX_CASES = {
    "gemma2-flat-141": (GEMMA2, M141, False, 1),
    "gemma2-flat-221": (GEMMA2, M221, False, 1),
    "gemma2-flat-122": (GEMMA2, M122, False, 1),
    "gemma2-hier-122": (GEMMA2, M122, True, 1),
    "olmo-flat-141-ga2": (OLMO, M141, False, 2),
    "deepseek-hier-122": (DEEPSEEK, M122, True, 1),
}
# the port's cases: name -> (arch, mesh, hierarchical, grad_accum, JAX case)
CASES = {n: c + (n,) for n, c in JAX_CASES.items() if n != "deepseek-hier-122"}
CASES["deepseek-flat-122"] = (DEEPSEEK, M122, False, 1, "deepseek-hier-122")


def _hp(hier, ga):
    return dict(fsdp=True, hierarchical=hier, grad_accum=ga)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fsdp"))
    inputs = {a: write_inputs(d, a, steps=STEPS) for a in (GEMMA2, OLMO, DEEPSEEK)}
    proc = jax_process({"devices": 4, "out": d, "cases": [
        dict(name=n, arch=a, mesh=m, hp=_hp(h, ga), opt=OPT, init=inputs[a], batches=inputs[a],
             steps=STEPS, keep=[0]) for n, (a, m, h, ga) in JAX_CASES.items()]},
        os.path.join(d, "jax.json"))
    try:
        run_ranks({"world": 4, "store": os.path.join(d, "store"), "out": d, "tasks": [
            dict(name=n, arch=a, mesh=m, hp=_hp(h, ga), opt=OPT, init=inputs[a],
                 batches=inputs[a], steps=STEPS, keep=[0])
            for n, (a, m, h, ga, _) in CASES.items()]},
            os.path.join(d, "ranks.json"))
    finally:
        wait_all([proc], 300)
    return d


def _index(key, shape, coords, mesh_shape, arch, block):
    """The index in JAX leaf ``key`` (global ``shape``) of DP block
    ``block`` of the ``model`` slice of the rank at ``coords``."""
    pod, data, model = mesh_shape
    is_moe = smoke_config(arch).moe is not None
    index = [slice(None)] * len(shape)
    local = list(shape)
    for d, a in enumerate(jsharding.param_pspec(key, shape, model, is_moe)):
        if a == "model":
            local[d] //= model
            index[d] = slice(coords[2] * local[d], (coords[2] + 1) * local[d])
    d = jsharding.zero1_dim(key, shape, model, pod * data, is_moe)
    if d is not None:
        n = local[d] // (pod * data)
        start = index[d].start or 0
        index[d] = slice(start + block * n, start + (block + 1) * n)
    return tuple(index)


def _load(runs, name):
    return [np.load(os.path.join(runs, f"{name}.rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_step_matches_jax(runs, name):
    check_fsdp_step(runs, name, CASES[name])


def check_fsdp_step(runs, name, case):
    """The steps of ``case`` (a ``CASES`` entry: arch, mesh, hierarchical,
    grad_accum, JAX case) on every rank against JAX's (module docstring)."""
    arch, (shape, axes), hier, ga, jax_name = case
    ranks = _load(runs, name)
    ref = np.load(os.path.join(runs, f"{jax_name}.jax.npz"))
    assert sorted(ref["device_ids"]) == list(range(4))
    for r, res in enumerate(ranks):  # row-major, as JAX's mesh.devices
        assert tuple(res["coords"]) == tuple(np.unravel_index(r, shape))
        assert ref["device_ids"][r] == r
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_array_equal(res[k], ranks[0][k])
    assert len(ref["loss"]) == len(ranks[0]["loss"]) == STEPS
    np.testing.assert_allclose(ranks[0]["loss"], ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["grad_norm"], ref["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["lr"], ref["lr"], rtol=1e-6)
    lr0 = float(ranks[0]["lr"][0])
    b1, eps = OptConfig().beta1, OptConfig().eps
    keys = [k[len("params/"):] for k in ranks[0].files if k.startswith("params/")]
    assert keys == [k[len("params/"):] for k in ref.files if k.startswith("params/")]
    steep_n = 0
    for key in keys:
        want = ref[f"after0/params/{key}"]

        def index(res, block):
            return _index(key, want.shape, res["coords"], shape, arch, block)

        jax_block = [moment_index(res["coords"][0], res["coords"][1], shape[0]) for res in ranks]
        m_jax = np.zeros(want.shape, np.float32)
        for r, res in enumerate(ranks):
            for p in ("after0/params", "params"):
                np.testing.assert_array_equal(res[f"{p}/{key}"], ranks[0][f"{p}/{key}"])
            m_jax[index(res, jax_block[r])] = ref[f"after0/m/{r}/{key}"]
        # the first step: AdamW's update is g / (|g| + eps), and where |g| is
        # near eps it moves by up to lr when g moves by its rounding
        # (tests/test_torch_tp.py)
        steep = np.abs(m_jax) / (1 - b1) < 10 * eps
        err = np.abs(ranks[0][f"after0/params/{key}"] - want)
        assert np.all(err[~steep] <= 3e-5), (key, err[~steep].max())
        assert np.all(err[steep] <= lr0 + 3e-5), (key, err[steep].max())
        steep_n += int((steep & (err > 3e-5)).sum())
        # after the second step: within AFTER_SECOND (see there)
        err = np.abs(ranks[0][f"params/{key}"] - ref[f"params/{key}"])
        assert np.all(err <= AFTER_SECOND), (key, err.max())
        for g in ("m", "v"):
            for r, res in enumerate(ranks):
                for p in ("after0/", ""):  # the rank's moments are its parameters' block
                    pod_i, data_i, _ = res["coords"]
                    mine = res[f"{p}full_{g}/{key}"][index(res, dp_index(pod_i, data_i,
                                                                          shape[1]))]
                    np.testing.assert_array_equal(res[f"{p}{g}/{key}"], mine)
                # JAX's shard at the rank's coordinates is the (data, pod) block
                theirs = ref[f"after0/{g}/{r}/{key}"]
                got = res[f"after0/full_{g}/{key}"][index(res, jax_block[r])]
                assert got.shape == theirs.shape, (g, key, r)
                tol = 1e-4 * np.abs(theirs).max() + 1e-4 * np.abs(theirs)
                diff = np.abs(got - theirs)
                assert np.all(diff <= tol), (g, key, r, diff.max())
    print(f"{name}: {steep_n} parameters with |m| < 10 eps differ from JAX by more than 3e-5")


@pytest.mark.parametrize("name", ["gemma2-flat-141", "gemma2-flat-122", "olmo-flat-141-ga2"])
def test_rank_holds_only_its_blocks(runs, name):
    check_blocks(runs, name, CASES[name])


def check_blocks(runs, name, case):
    """Each rank of ``case`` holds the blocks ``param_specs(fsdp=True)``
    gives of every parameter and moment, and no more."""
    arch, (shape, axes), *_, jax_name = case
    cfg = smoke_config(arch)
    ref = np.load(os.path.join(runs, f"{jax_name}.jax.npz"))
    jspecs = jsharding.param_specs(
        {k[len("params/"):]: jax.ShapeDtypeStruct(ref[k].shape, np.float32)
         for k in ref.files if k.startswith("params/")}, _StubMesh(shape, axes), cfg, fsdp=True)
    sizes = dict(zip(axes, shape))
    full = 0
    for r, res in enumerate(_load(runs, name)):
        held = 0
        for key, spec in jspecs.items():
            whole = ref[f"params/{key}"].shape
            want = []
            for n, a in zip(whole, tuple(spec) + (None,) * (len(whole) - len(spec))):
                parts = (a,) if isinstance(a, str) else (a or ())
                want.append(n // int(np.prod([sizes[x] for x in parts])))
            assert tuple(res[f"local/{key}"]) == tuple(want), key
            for g in ("m", "v"):
                assert res[f"{g}/{key}"].shape == tuple(want), (g, key)
            held += int(np.prod(want))
            full += int(np.prod(whole)) if r == 0 else 0
        assert int(res["numel"]) == held
        assert held < full / shape[1] * 1.1  # the blocks, and the few whole leaves


class _StubMesh:
    """What JAX's rules read of a mesh: axis names and a devices array."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


def test_comm_counts_fsdp_collectives_under_the_dp_group(runs):
    """Flat ZeRO-3 at (1, 4, 1): each cut leaf is gathered (all-gather
    output) and its gradient reduce-scattered (fp32 input) once a use and a
    microbatch, the tied table twice (the embedding and the loss); then the
    loss, the whole leaves' gradients and the cut leaves' squares are
    all-reduced."""
    for name in ("gemma2-flat-141", "olmo-flat-141-ga2"):
        check_comm(runs, name, CASES[name])


def tied_table_uses(cfg, key: str) -> int:
    """How often one pass gathers leaf ``key``: twice for the tied table
    (the decoder's ``embed/tok``, the VLM's ``lm/embed/tok``, whisper's
    ``tok``: the embedding and the logits or the loss), else once."""
    return 2 if cfg.tie_embeddings and key in ("embed/tok", "lm/embed/tok", "tok") else 1


def check_comm(runs, name, case):
    """The DP group's calls and bytes of the last step of ``case`` (a flat
    step at (1, 4, 1)) against those the leaves imply: one gather and one
    gradient reduction a use, a layer and a microbatch."""
    arch, (shape, _), _, ga, jax_name = case
    cfg = smoke_config(arch)
    leaves, _ = stacked_shapes(cfg)
    ref = np.load(os.path.join(runs, f"{jax_name}.jax.npz"))
    calls = nbytes = 0
    n_cut = 0
    for key in (k[len("params/"):] for k in ref.files if k.startswith("params/")):
        whole = ref[f"params/{key}"].shape
        size = int(np.prod(whole)) * 4
        d = jsharding.zero1_dim(key, whole, 1, 4, cfg.moe is not None)
        if d is None:
            calls, nbytes = calls + 1, nbytes + size
            continue
        n_cut += 1
        uses = tied_table_uses(cfg, key)
        pieces = len(leaves[key]) if isinstance(leaves[key], tuple) else 1  # one a layer
        calls += 2 * uses * ga * pieces
        nbytes += 2 * uses * ga * size
    calls, nbytes = calls + 2, nbytes + 4 + 4 * n_cut  # the loss, the squares
    for res in _load(runs, name):
        assert tuple(res["comm/pod+data"]) == (calls, nbytes), name
        assert [k for k in res.files if k.startswith("comm/")] == ["comm/pod+data"]


def test_hierarchical_fsdp_across_pods_raises_c9():
    cfg = smoke_config(GEMMA2)
    with pytest.raises(NotImplementedError, match=r"ROADMAP C\.9"):
        make_train_step(get_api(cfg, device="cpu"), cfg, OptConfig(), mesh_layout(*M221),
                        TrainHparams(hierarchical=True, fsdp=True), {"tokens": (8, 16)})

