"""bf16 parity of the port with the JAX models, on the CPU.

Both stacks run the 2-layer smoke configs at param and compute dtype
bfloat16, with one set of weights carried over by the bridge.  bf16 rounds
at other places in the two frameworks, so the logits differ by up to ~0.05
on the dense archs: the test there is that greedy decoding picks the same
token at every position.  rwkv6 is held block by block instead: its time
mix and channel mix, each alone on one bf16 input, agree with JAX's within
two bf16 steps at |y| in [1, 2) (2^-6) plus one relative step, and within
2e-3 on average.  One step (2^-7 = 0.0078) is not enough: the two stacks
round r, k, the gates and the squared ReLU to bf16 at other places, and
each output multiplies two such values (time mix: 37 of 2048 entries beyond
0.0078, at most 0.0117; channel mix: 9, at most 0.0156).  A whole-model
bound would be loose, because the per-block gaps build up across the
recurrent layers.  whisper-small and internvl2-1b are held whole, as the
dense archs are: greedy tokens at every position of the train-mode logits
of JAX's jitted model, from the same bf16 weights, frames and patches
(this catches whisper's cast of frames and sinusoid before their sum, and
the projector's tanh-GELU rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import get_api as jget_api  # noqa: E402
from repro.models import make_smoke_batch as jbatch  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import smoke_config as jsmoke  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch.models import make_smoke_batch, smoke_config, transformer  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import model_class  # noqa: E402

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16", num_layers=2)
BF16_STEP = 2.0 ** -7


def _bridged(arch):
    jcfg = jsmoke(arch).replace(**BF16)
    jparams = jget_api(jcfg).init(jax.random.PRNGKey(0))
    cfg = smoke_config(arch).replace(**BF16)
    model = model_class(cfg)(cfg, torch.device("cpu"))
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    model.load_state_dict(sd, strict=True)
    return jcfg, jparams, cfg, model


@pytest.mark.parametrize("arch", ["gemma-2b", "olmo-1b", "gemma2-9b", "qwen2.5-14b"])
def test_bf16_greedy_tokens_match_jax(arch):
    jcfg, jparams, cfg, model = _bridged(arch)
    jb = jbatch(jcfg, batch=2, seq=16)
    tb = make_smoke_batch(cfg, batch=2, seq=16, device="cpu")
    jlogits, _, _ = jtransformer.apply_lm(jparams, jb["tokens"], jcfg)
    with torch.no_grad():
        logits, _ = transformer.apply_lm(model, tb["tokens"])
    assert logits.shape == tuple(jlogits.shape)
    want = np.asarray(jnp.argmax(jlogits.astype(jnp.float32), axis=-1))
    np.testing.assert_array_equal(logits.float().argmax(-1).numpy(), want)


def _jax_whisper(params, batch, cfg):
    return jwhisper.decode(params, batch["tokens"], jwhisper.encode(params, batch["frames"], cfg),
                           cfg)[0]


def _jax_vlm(params, batch, cfg):
    return jvlm.apply_vlm(params, batch["tokens"], batch["patches"], cfg)[0]


@pytest.mark.parametrize("arch,jax_fn,extra", [
    ("whisper-small", _jax_whisper, "frames"), ("internvl2-1b", _jax_vlm, "patches")])
def test_bf16_encoder_decoder_and_vlm_greedy_tokens_match_jax(arch, jax_fn, extra):
    jcfg, jparams, cfg, model = _bridged(arch)
    jb = jbatch(jcfg, batch=2, seq=16)
    tb = make_smoke_batch(cfg, batch=2, seq=16, device="cpu")
    jlogits = jax.jit(jax_fn, static_argnums=2)(jparams, jb, jcfg)
    with torch.no_grad():
        logits, _ = model(tb["tokens"], tb[extra])
    assert logits.shape == tuple(jlogits.shape) and logits.dtype == torch.float32
    want = np.asarray(jnp.argmax(jlogits.astype(jnp.float32), axis=-1))
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), want)


def _layer0(tree):
    """Layer 0's leaves of the stacked JAX unit params."""
    return jax.tree_util.tree_map(lambda a: a[0], tree)


@pytest.mark.parametrize("block", ["time_mix", "channel_mix"])
def test_bf16_rwkv_blocks_match_jax(block):
    jcfg, jparams, cfg, model = _bridged("rwkv6-1.6b")
    x = np.random.default_rng(0).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    unit = jparams["units"]["l0"]
    layer = model.layers[0]
    with torch.no_grad():
        if block == "time_mix":
            want, _ = jrwkv.rwkv_time_mix(_layer0(unit["mix"]), jx, jcfg)
            got = layer.mix(tx)
        else:
            want, _ = jrwkv.rwkv_channel_mix(_layer0(unit["ffn"]), jx, jcfg)
            got = layer.ffn(tx)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    gap = np.abs(got.float().numpy() - want)
    # two bf16 steps at |y| in [1, 2) plus one relative step: the output is a
    # product of two factors that each may round one step apart
    assert (gap <= 2 * BF16_STEP + BF16_STEP * np.abs(want)).all(), gap.max()
    assert gap.mean() <= 2e-3
