"""The port's configs equal the JAX package's, field by field, for all 10
architectures (full and smoke), including param_counts and the plans."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import smoke_config as tsmoke  # noqa: E402

ARCHS = sorted(jconfigs.ARCH_IDS)


def test_same_arch_ids():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_config_fields_equal(arch, variant):
    if variant == "full":
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    else:
        j, t = jsmoke(arch), tsmoke(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_counts() == j.param_counts()
    assert t.pdtype == getattr(torch, j.param_dtype)
    assert t.cdtype == getattr(torch, j.compute_dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_equal(arch):
    assert dataclasses.asdict(tconfigs.get_plan(arch)) == dataclasses.asdict(
        jconfigs.get_plan(arch)
    )
