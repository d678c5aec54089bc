"""The port's Cross Wiring control plane against the JAX package's: the
job's demand (``configs.job_demand``), MDMCF's OCS configuration, LTRR and
the train launcher's ``[control-plane]`` line, for every arch; and MDMCF on
random feasible demands, cold and warm-started.

The port's ``ring_demand`` departs from the reference's on a 2-pod ring
only (ROADMAP C.2): it asks ``2 × links`` per pair, the answer of
``tests/test_logical.py::test_ring_demand_two_pods``; on 3 or more pods the
two are equal.
"""
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import decomposition as jdec  # noqa: E402
from repro.core import logical as jlogical  # noqa: E402
from repro.core import reconfig as jreconfig  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ClusterSpec, CrossWiring, Uniform, check_edge_coloring, check_symmetric_split,
    config_cosine, demand_feasible, edge_color_bipartite, ltrr, mdmcf_reconfigure,
    ring_demand, symmetric_split)
from repro_torch.launch import train as train_cli  # noqa: E402

LAUNCHER_SPEC = dict(num_pods=8, k_spine=16, k_leaf=16)


@pytest.mark.parametrize("pods", [3, 4])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_control_plane_equals_jax(arch, pods):
    spec, jspec = ClusterSpec(**LAUNCHER_SPEC), jtopology.ClusterSpec(**LAUNCHER_SPEC)
    ring = tuple(range(pods))
    want_demand = jconfigs.job_demand(jconfigs.get_plan(arch), jspec, ring)
    got_demand = configs.job_demand(configs.get_plan(arch), spec, ring)
    assert got_demand.dtype == want_demand.dtype
    np.testing.assert_array_equal(got_demand, want_demand)

    got, want = train_cli.control_plane(arch, pods), jtrain.control_plane(arch, pods)
    assert got["pods"] == want["pods"] == ring
    assert got["demand_links"] == want["demand_links"] > 0
    assert got["ltrr"] == want["ltrr"]
    np.testing.assert_allclose(got["ltrr"], 1.0, rtol=1e-12)
    np.testing.assert_array_equal(got["config"].x, want["config"].x)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("pods", [3, 4])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_control_plane_line_is_jax_s(arch, pods, monkeypatch, capsys):
    """JAX's launcher prints its line, then stops where its data plane
    would begin; the port's line is the same but for MDMCF's time."""
    def stop(*_, **__):
        raise _Stop
    monkeypatch.setattr(jtrain, "get_api", stop)
    monkeypatch.setattr("sys.argv", ["train", "--arch", arch, "--smoke", "--pods", str(pods)])
    with pytest.raises(_Stop):
        jtrain.main()
    want = capsys.readouterr().out.strip()
    got = train_cli.control_plane_line(arch, train_cli.control_plane(arch, pods))
    mdmcf = re.compile(r"mdmcf=\d+\.\d ms$")
    assert mdmcf.search(got) and mdmcf.search(want), (got, want)
    assert mdmcf.sub("", got) == mdmcf.sub("", want)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_two_pod_ring_asks_both_directions(arch):
    """2 × links per pair per group, twice the reference's collapsed ring,
    and the port's MDMCF realises it as the reference's MDMCF does."""
    spec, jspec = ClusterSpec(**LAUNCHER_SPEC), jtopology.ClusterSpec(**LAUNCHER_SPEC)
    plan = configs.get_plan(arch)
    C = configs.job_demand(plan, spec, (0, 1))
    links = plan.ocs_links_per_ring_hop
    assert (C[:, 0, 1] == 2 * links).all() and (C[:, 1, 0] == 2 * links).all()
    assert C.sum() == 2 * 2 * links * spec.num_ocs_groups
    np.testing.assert_array_equal(C, 2 * jconfigs.job_demand(jconfigs.get_plan(arch), jspec, (0, 1)))
    got, want = mdmcf_reconfigure(spec, C), jreconfig.mdmcf_reconfigure(jspec, C)
    np.testing.assert_array_equal(got.config.x, want.config.x)
    np.testing.assert_array_equal(got.config.realized(), C)
    assert train_cli.control_plane(arch, 2)["demand_links"] == 2 * links * spec.num_ocs_groups


def test_ring_demand_two_pods_numbers():
    """The numbers of tests/test_logical.py::test_ring_demand_two_pods."""
    spec = ClusterSpec(num_pods=4, k_spine=8, k_leaf=4)
    C = ring_demand(spec, [1, 3], links=3)
    assert C[0, 1, 3] == 6 and C[0, 3, 1] == 6
    assert demand_feasible(C, spec)
    assert C.sum() == 2 * 6 * spec.num_ocs_groups


def _spec_and_demand(seed, pods, k_spine, fill):
    spec = ClusterSpec(num_pods=pods, k_spine=k_spine, k_leaf=4)
    jspec = jtopology.ClusterSpec(num_pods=pods, k_spine=k_spine, k_leaf=4)
    C = jlogical.random_feasible_demand(jspec, np.random.default_rng(seed), fill=fill)
    return spec, jspec, C


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), pods=st.integers(2, 9),
       k_spine=st.sampled_from([2, 4, 8, 16]), fill=st.sampled_from([0.5, 1.0]))
def test_mdmcf_equals_jax_on_random_demands(seed, pods, k_spine, fill):
    spec, jspec, C = _spec_and_demand(seed, pods, k_spine, fill)
    _, _, C_old = _spec_and_demand(seed + 1, pods, k_spine, fill)
    old = jreconfig.mdmcf_reconfigure(jspec, C_old).config
    for kw in ({}, {"old": old}, {"old": old, "slot_match": False}):
        got = mdmcf_reconfigure(spec, C, **kw)
        want = jreconfig.mdmcf_reconfigure(jspec, C, **kw)
        np.testing.assert_array_equal(got.config.x, want.config.x)
        np.testing.assert_array_equal(got.config.realized(), C)  # Thm 4.1: exact
        assert CrossWiring(spec).l2_feasible(got.config)
        assert ltrr(got.config, C) == jreconfig.ltrr(want.config, C)
        assert got.config.x.flags.writeable is False
    # the pieces, each held by the port's and the reference's checks
    for h in range(C.shape[0]):
        A = symmetric_split(C[h])
        np.testing.assert_array_equal(A, jdec.symmetric_split(C[h]))
        check_symmetric_split(C[h], A)
        jdec.check_symmetric_split(C[h], A)
        colors = edge_color_bipartite(A, k_spine // 2, warm=old.x[h, 0::2])
        np.testing.assert_array_equal(colors, jdec.edge_color_bipartite(
            A, k_spine // 2, warm=old.x[h, 0::2]))
        check_edge_coloring(A, colors)
        jdec.check_edge_coloring(A, colors)
    # the configuration's views
    cfg, jcfg = mdmcf_reconfigure(spec, C, old=old).config, jreconfig.mdmcf_reconfigure(
        jspec, C, old=old).config
    assert cfg.rewiring_distance(old) == jcfg.rewiring_distance(old)
    assert cfg.changed_pairs(old) == jcfg.changed_pairs(old)
    assert cfg.dark_pairs(old) == jcfg.dark_pairs(old)
    assert config_cosine(cfg, old) == jreconfig.config_cosine(jcfg, old)
    np.testing.assert_array_equal(cfg.pair_capacity(), jcfg.pair_capacity())
    np.testing.assert_array_equal(cfg.realized_bidirectional(), jcfg.realized_bidirectional())
    assert Uniform(spec).l2_feasible(cfg) == jtopology.Uniform(jspec).l2_feasible(jcfg)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), pods=st.integers(2, 7))
def test_symmetric_split_mcf_equals_jax(seed, pods):
    _, _, C = _spec_and_demand(seed, pods, 8, 1.0)
    for h in range(C.shape[0]):
        got = symmetric_split(C[h], method="mcf")
        np.testing.assert_array_equal(got, jdec.symmetric_split(C[h], method="mcf"))
        check_symmetric_split(C[h], got)


def test_infeasible_demand_and_spec_raise_as_in_jax():
    spec = ClusterSpec(num_pods=3, k_spine=4, k_leaf=4)
    C = np.zeros((spec.num_ocs_groups, 3, 3), dtype=np.int64)
    C[:, 0, 1] = 1  # not symmetric
    assert not demand_feasible(C, spec)
    with pytest.raises(ValueError, match="11"):
        mdmcf_reconfigure(spec, C)
    C[:, 1, 0] = 1
    C[:, 0, 2] = C[:, 2, 0] = 4  # pod 0's degree 5 > K_spine 4
    assert not demand_feasible(C, spec)
    for bad in (dict(num_pods=3, k_spine=3), dict(num_pods=3, k_leaf=3, tau=2),
                dict(num_pods=600), dict(num_pods=3, slowdown_cap=0.5)):
        with pytest.raises(ValueError):
            ClusterSpec(**bad)
        with pytest.raises(ValueError):
            jtopology.ClusterSpec(**bad)
