"""The port's serving engine against the JAX engine: identical greedy
tokens from identical weights (whisper's and the VLM's from the same
frames and patches too), the same KV bytes per token as the simulator's
analytic formula (and the JAX engine's fixed bytes for rwkv6's and
jamba's recurrent state, whisper's encoder output and the VLM's vision
prefix), and the CLI on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.dist.demand import kv_bytes_per_token  # noqa: E402
from repro.models import get_api as jget_api  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import get_api, modality_inputs, smoke_config  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

DENSE = ["gemma-2b", "olmo-1b", "gemma2-9b", "qwen2.5-14b"]
RWKV = "rwkv6-1.6b"
HYBRID = "jamba-1.5-large-398b"
WHISPER, VLM = "whisper-small", "internvl2-1b"


def _inputs(cfg, rng):
    """A prompt (2, 16) and, for whisper and the VLM, frames or patches."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)}
    return {**out, **modality_inputs(cfg, rng, 2)}


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b", RWKV, HYBRID, WHISPER, VLM])
def test_greedy_tokens_equal_jax(arch):
    jcfg = jsmoke(arch)
    japi = jget_api(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    inputs = _inputs(jcfg, np.random.default_rng(1))
    want = JServeEngine(japi, jparams, batch=2, s_max=26).generate(inputs, max_new_tokens=8)

    cfg = smoke_config(arch)
    api = get_api(cfg, device="cpu")
    model = api.init()
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg))
    eng = ServeEngine(api, model, batch=2, s_max=26)
    got = eng.generate(inputs, max_new_tokens=8)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    assert eng.timing["decode_steps"] == 7


@pytest.mark.parametrize("arch", DENSE)
def test_kv_bytes_match_the_simulator_formula(arch):
    cfg = smoke_config(arch)
    prof = ServeEngine(get_api(cfg, device="cpu"), None, batch=2, s_max=32).comm_profile()
    assert prof["kv_bytes_per_token"] == kv_bytes_per_token(jsmoke(arch)) > 0
    assert prof["fixed_state_bytes"] == 0.0
    full = ServeEngine(get_api(cfg.replace(compute_dtype="bfloat16"), device="cpu"), None,
                       batch=1, s_max=8).comm_profile()
    assert full["kv_bytes_per_token"] == kv_bytes_per_token(
        jsmoke(arch).replace(compute_dtype="bfloat16"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_comm_profile_matches_jax(dtype):
    """A recurrent state does not grow with context: 0 KV bytes per token,
    as the JAX engine and the simulator's formula give, and the same fixed
    state bytes as the JAX engine less its 4-byte int32 ``pos`` leaf."""
    jcfg = jsmoke(RWKV).replace(compute_dtype=dtype, num_layers=2)
    want = JServeEngine(jget_api(jcfg), None, batch=2, s_max=32).comm_profile()
    cfg = smoke_config(RWKV).replace(compute_dtype=dtype, num_layers=2)
    got = ServeEngine(get_api(cfg, device="cpu"), None, batch=2, s_max=32).comm_profile()
    assert got["kv_bytes_per_token"] == want["kv_bytes_per_token"] == kv_bytes_per_token(jcfg) == 0
    assert got["fixed_state_bytes"] == want["fixed_state_bytes"] - 4 > 0
    for key in ("dtype_bytes", "num_layers", "batch_slots"):
        assert got[key] == want[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_comm_profile_matches_jax(dtype):
    """jamba's one attention layer in 8 grows the cache (2 x Hkv x Dh a
    token, as the simulator's formula counts it); its 7 Mamba layers hold
    a fixed state (the conv buffer in cdtype, the fp32 scan state), the
    JAX engine's fixed bytes less its 4-byte ``pos``."""
    jcfg = jsmoke(HYBRID).replace(compute_dtype=dtype)
    want = JServeEngine(jget_api(jcfg), None, batch=2, s_max=32).comm_profile()
    cfg = smoke_config(HYBRID).replace(compute_dtype=dtype)
    got = ServeEngine(get_api(cfg, device="cpu"), None, batch=2, s_max=32).comm_profile()
    item = 4 if dtype == "float32" else 2
    assert got["kv_bytes_per_token"] == want["kv_bytes_per_token"] == kv_bytes_per_token(jcfg) \
        == 2 * cfg.num_kv_heads * cfg.head_dim * item
    d_in, mc = cfg.mamba.expand * cfg.d_model, cfg.mamba
    assert got["fixed_state_bytes"] == want["fixed_state_bytes"] - 4 \
        == 7 * ((mc.d_conv - 1) * d_in * item + d_in * mc.d_state * 4)
    for key in ("dtype_bytes", "num_layers", "batch_slots"):
        assert got[key] == want[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_encoder_decoder_and_vlm_comm_profile_matches_jax(arch, dtype):
    """Whisper's KV grows by its decoder layers' self-attention (2 x Hkv x
    Dh a layer); its encoder output ``enc`` (encoder_seq x d) is fixed.
    The VLM's cache holds the vision prefix in vision_tokens slots that
    every request fills: fixed bytes of vision_tokens tokens.  Both equal
    the JAX engine's, less its 4-byte ``pos``."""
    jcfg = jsmoke(arch).replace(compute_dtype=dtype)
    want = JServeEngine(jget_api(jcfg), None, batch=2, s_max=32).comm_profile()
    cfg = smoke_config(arch).replace(compute_dtype=dtype)
    got = ServeEngine(get_api(cfg, device="cpu"), None, batch=2, s_max=32).comm_profile()
    item = 4 if dtype == "float32" else 2
    kv = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim * item
    fixed = (cfg.encoder_seq * cfg.d_model * item if arch == WHISPER
             else cfg.vision_tokens * kv)
    assert got["kv_bytes_per_token"] == want["kv_bytes_per_token"] == kv
    assert got["fixed_state_bytes"] == want["fixed_state_bytes"] - 4 == fixed
    for key in ("dtype_bytes", "num_layers", "batch_slots"):
        assert got[key] == want[key]


def test_generate_refuses_to_overrun_the_cache():
    cfg = smoke_config("gemma-2b")
    api = get_api(cfg, device="cpu")
    eng = ServeEngine(api, api.init(), batch=1, s_max=10)
    with pytest.raises(ValueError, match="s_max"):
        eng.generate({"tokens": np.zeros((1, 8), np.int64)}, max_new_tokens=4)


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b", RWKV, HYBRID, WHISPER, VLM])
def test_cli_runs_on_the_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "tok/s" in out
