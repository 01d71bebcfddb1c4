"""WavLM's materialised-bias escape hatch in the port against the JAX package,
on the CPU.

The JAX ``flash_mha_bias`` (the Pallas TPU flash attention with an additive
bias) runs in TPU interpret mode; the port's CPU path runs its plain
version, ``flash_mha_bias_reference``, which ``chip_smoke.py`` holds the
CUDA kernel to on the card. The JAX ``wavlm_encode`` takes its hatch on the
CPU when ``_flash_available`` answers True and
``STUTTER_TPU_LONG_ATTENTION_FLASH`` and ``_MIN_L`` are set, as they are
here with ``monkeypatch``.

Bars:
- the plain version against the JAX kernel: f32 2e-6 max-abs (sums in
  another order and an online softmax over 512-key blocks); bf16 cosine
  1e-5 and one bf16 step (2^-8 relative) of max-abs: the Pallas kernel
  rounds the unnormalised probabilities to bf16 before the second product,
  the plain version rounds only its output;
- the encode, bf16 at head_dim 64: the repo's 1e-3 pooled cosine against
  JAX, and 1e-4 against the port's own gated path (the kernel path's bar on
  the card: the two differ only in where gate * bias + mask is added).

The encode's config is ``WavLMConfig.tiny(128, 2, 2)`` with 4 positional
conv groups, not 16: PyTorch's CPU bf16 grouped conv1d is wrong at 8
channels a group (a 128-wide, 16-group, k = 128 conv in bf16 lands ~1.0 in
cosine distance from the same conv in f32 on this host, and 8e-6 at 32
channels a group). WavLM's own configs have 48 or 64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import stutter_tpu.models.attention as jattention
from stutter_tpu.models import wavlm as jw
from stutter_tpu_torch.cli import extract_wavlm
from stutter_tpu_torch.cli import finetune as finetune_cli
from stutter_tpu_torch.extract.pipeline import WavLMExtractor
from stutter_tpu_torch.models import wavlm as tw
from stutter_tpu_torch.ops import flash_mha as tmha
from stutter_tpu_torch.weights.convert import wavlm_params_from_numpy
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

F32_MAX_ABS = 2e-6
BF16_COSINE = 1e-5
ENCODE_COSINE_VS_JAX = 1e-3
ENCODE_COSINE_VS_GATED = 1e-4


def _inputs(rng, B, H, L, dtype):
    """q, k, v [B, H, L, 64] and ab = gate * bias + key mask [B, H, L, L] f32,
    with clip 1's keys masked from L - 150 on."""
    q, k, v = (rng.randn(B, H, L, 64).astype(np.float32) * 0.3 for _ in range(3))
    if dtype == "bf16":  # bf16-representable, so both sides see the same values
        q, k, v = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32) for t in (q, k, v))
    gate = rng.rand(B, H, L).astype(np.float32)
    bias = rng.randn(H, L, L).astype(np.float32)
    mask = np.zeros((B, L), np.float32)
    mask[1, L - 150:] = -1e9
    ab = gate[..., None] * bias[None] + mask[:, None, None, :]
    return q, k, v, ab.astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_matches_jax_flash_mha_bias(rng, dtype):
    """B = 2, H = 2, L = 600: two 512-blocks on the JAX side (L padded to
    1024 with ab = -1e9), one clip with its last 150 keys masked."""
    q, k, v, ab = _inputs(rng, 2, 2, 600, dtype)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jattention.flash_mha_bias(
            *(jnp.asarray(t, jdt) for t in (q, k, v)), jnp.asarray(ab)), np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    ours = tmha.flash_mha_bias_reference(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                                         torch.from_numpy(ab))
    assert ours.dtype == tdt and tuple(ours.shape) == ref.shape == (2, 2, 600, 64)
    ours = ours.float().numpy()
    max_abs, cos = float(np.abs(ours - ref).max()), cosine_distance(ours, ref)
    print(f"{dtype}: flash_mha_bias plain version vs JAX Pallas, max-abs {max_abs:.3e}, "
          f"cosine {cos:.3e}")
    if dtype == "f32":
        assert max_abs <= F32_MAX_ABS
    else:
        assert cos <= BF16_COSINE
        assert max_abs <= 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tmha.flash_mha_bias(q, q, q, torch.zeros(1, 1, 8, 8))
    assert tmha.flash_mha_bias.launches == 0


def _pair(cfg):
    """(JAX bf16 params, port bf16 model) holding the same weights; constant
    leaves (zero biases, unit norms) get seeded noise, as
    tests/test_torch_wavlm.py does."""
    r = np.random.RandomState(0)

    def perturb(a):
        a = np.asarray(a)
        return a + (0.1 * r.randn(*a.shape)).astype(a.dtype) if np.all(a == a.flat[0]) else a

    tree = jax.tree.map(perturb, jw.init_wavlm_params(
        jax.random.key(0), jw.WavLMConfig(**dataclasses.asdict(cfg))))
    model = tw.WavLMModel(cfg, dtype=torch.bfloat16)
    model.load_state_dict(wavlm_params_from_numpy(tree, cfg))  # casts, as the fast preset does
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree), model


# head_dim 64; 32 channels a positional-conv group (see the module docstring)
HATCH_CFG = dataclasses.replace(tw.WavLMConfig.tiny(128, 2, 2), num_conv_pos_embedding_groups=4)


@pytest.fixture(scope="module")
def hatch_encodes():
    """HATCH_CFG in bf16, 2 clips of 1 s and 0.7 s (L = 799 frames of the
    tiny stem), the hatch from 8 frames up: (JAX hatch, port hatch, port
    gated path, JAX and port hatch calls)."""
    cfg = HATCH_CFG
    params, model = _pair(cfg)
    r = np.random.RandomState(4)
    w = (r.randn(2, 16000) * 0.3).astype(np.float32)
    lengths = np.array([16000, 11200], np.int32)
    w[1, 11200:] = 0.0
    layers = (2, 1, 0)
    calls = {"jax": 0, "port": 0}
    real_jax, real_port = jattention.flash_mha_bias, tw.flash_mha_bias_reference

    def jax_spy(*a, **kw):
        calls["jax"] += 1
        return real_jax(*a, **kw)

    def port_spy(*a, **kw):
        calls["port"] += 1
        return real_port(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jattention, "_flash_available", lambda: True)
        mp.setattr(jattention, "flash_mha_bias", jax_spy)
        mp.setattr(tw, "flash_mha_bias_reference", port_spy)
        mp.setenv("STUTTER_TPU_LONG_ATTENTION_FLASH", "1")
        mp.setenv("STUTTER_TPU_LONG_ATTENTION_MIN_L", "8")
        jax.clear_caches()  # wavlm_encode's jit cache may hold a trace without the hatch
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jw.wavlm_encode(
                params, jnp.asarray(w), jw.WavLMConfig(**dataclasses.asdict(cfg)), layers,
                jnp.asarray(lengths), precision=jax.lax.Precision.DEFAULT,
                activation_dtype=jnp.bfloat16))
        jax.clear_caches()
        wt, lt = torch.from_numpy(w), torch.from_numpy(lengths).long()
        hatch = model.encode(wt, layers, lt,
                             attention_fn=tw.materialized_bias_attention(8)).numpy()
        gated = model.encode(wt, layers, lt).numpy()
    return ref, hatch, gated, calls


def test_encode_with_hatch_matches_jax(hatch_encodes):
    ref, hatch, gated, calls = hatch_encodes
    assert calls["jax"] >= 1  # lax.scan traces the layer once
    assert calls["port"] == 2  # once a layer
    assert hatch.shape == ref.shape == (3, 2, 128) and np.isfinite(hatch).all()
    vs_jax = max(cosine_distance(hatch[s, b], ref[s, b]) for s in range(3) for b in range(2))
    vs_gated = max(cosine_distance(hatch[s, b], gated[s, b]) for s in range(3) for b in range(2))
    print(f"hatch encode: vs JAX hatch {vs_jax:.3e}, vs the port's gated path {vs_gated:.3e}")
    assert vs_jax <= ENCODE_COSINE_VS_JAX
    assert vs_gated <= ENCODE_COSINE_VS_GATED


@pytest.mark.parametrize("case,takes_hatch", [
    ("bf16_at_min_l", True), ("bf16_below_min_l", False), ("f32", False),
    ("head_dim_32", False)])
def test_hatch_gate(monkeypatch, case, takes_hatch):
    """The JAX gate: bf16, L >= long_min_l, head_dim >= 64; everything else
    goes to gated_relpos_attention."""
    seen = []
    monkeypatch.setattr(tw, "flash_mha_bias_reference",
                        lambda *a: seen.append("hatch") or a[0])
    monkeypatch.setattr(tw, "gated_relpos_attention", lambda *a: seen.append("gated") or a[0])
    L = 15 if case == "bf16_below_min_l" else 16
    d = 32 if case == "head_dim_32" else 64
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    q = torch.zeros(2, 3, L, d, dtype=dtype)
    tw.materialized_bias_attention(16)(q, q, q, torch.zeros(3, L, L), torch.zeros(2, 3, L),
                                       torch.zeros(2, L))
    assert seen == ["hatch" if takes_hatch else "gated"]


def test_extractor_takes_the_hatch(monkeypatch):
    """WavLMExtractor(long_attention="materialized_bias") passes the hatch to
    encode; the default keeps the gated path."""
    _, model = _pair(HATCH_CFG)
    seen = []
    monkeypatch.setattr(tw, "flash_mha_bias_reference",
                        lambda q, *a: seen.append(q.shape[2]) or torch.zeros_like(q))
    waves, scale = np.zeros((2, 4000), np.float32), np.ones(2, np.float32)
    lengths = np.array([4000, 3000])
    with pytest.raises(ValueError, match="long_attention"):
        WavLMExtractor(model.float(), "cpu", preset="fast", long_attention="flash")
    gated = WavLMExtractor(model.float(), "cpu", preset="fast")
    assert gated.attention_fn is None
    gated._encode(waves, scale, lengths)
    assert seen == []
    hatch = WavLMExtractor(model.float(), "cpu", preset="fast",
                           long_attention="materialized_bias", long_min_l=100)
    hatch._encode(waves, scale, lengths)
    assert seen == [199, 199]  # L = 199 frames of the tiny stem, once a layer


@pytest.mark.parametrize("env,expect", [
    ({}, {"long_attention": "gated"}),
    ({"STUTTER_TPU_LONG_ATTENTION_FLASH": ""}, {"long_attention": "gated"}),
    ({"STUTTER_TPU_LONG_ATTENTION_FLASH": "1", "STUTTER_TPU_LONG_ATTENTION_MIN_L": "608"},
     {"long_attention": "materialized_bias", "long_min_l": 608}),
])
def test_cli_reads_the_jax_switch(env, expect):
    assert extract_wavlm.long_attention_from_env(env) == expect


def test_finetune_refuses_the_switch(monkeypatch, tmp_path):
    monkeypatch.setenv("STUTTER_TPU_LONG_ATTENTION_FLASH", "1")
    with pytest.raises(NotImplementedError, match="LONG_ATTENTION_FLASH"):
        finetune_cli.main(["--data_dir", str(tmp_path), "--results_dir", str(tmp_path / "r"),
                           "--random_init", "--device", "cpu"])
