"""Import guard: the port and chip_smoke.py import neither JAX nor the
``repro`` package, and the port's entry points default to the card."""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    root = os.path.join(REPO, "src")
    mods = []
    for dirpath, _, files in os.walk(os.path.join(root, "repro_torch")):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_no_jax_and_no_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.flash_attention" in mods and len(mods) > 15
    assert {"repro_torch.core", "repro_torch.core.reconfig", "repro_torch.ckpt",
            "repro_torch.ckpt.manager"} <= set(mods)
    code = textwrap.dedent(f"""
        import importlib, importlib.util, sys
        for m in {mods!r}:
            importlib.import_module(m)
        spec = importlib.util.spec_from_file_location("chip_smoke", {os.path.join(REPO, "chip_smoke.py")!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        assert "triton" not in sys.modules  # imported only when a kernel launches

        import torch
        from repro_torch.models import get_api, smoke_config
        from repro_torch.serve.engine import ServeEngine
        api = get_api(smoke_config("gemma-2b"))
        assert api.device == torch.device("cuda"), api.device
        assert ServeEngine(api, None, batch=1, s_max=8).device == torch.device("cuda")
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "clean" in res.stdout
