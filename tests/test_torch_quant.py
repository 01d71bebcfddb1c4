"""The port's int8 turbo presets against the JAX package's, on the CPU.

int8 x int8 -> int32 is exact and both packages round half to even, so on
the same bf16 inputs the int8 weights, scales, quantized activations, int32
accumulators and f32 results are bit-equal. End to end, at WavLM-Large and
Whisper-large widths with 2 layers:
- turbo against the JAX f32 forward: the JAX turbo tests' 2e-2 pooled
  cosine distance (tests/test_quant.py:153,184);
- turbo against the JAX turbo forward: 1e-3. Upstream bf16 values differ
  in their last bits (the port's fast path sits ~3e-5 from JAX), and a
  last-bit difference can move an activation across an int8 rounding
  boundary: one quantum of 1/127 of the token's absmax.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stutter_tpu.audio.synthetic import make_synthetic_corpus
from stutter_tpu.extract import WavLMExtractor as JaxWavLMExtractor
from stutter_tpu.extract import WhisperExtractor as JaxWhisperExtractor
from stutter_tpu.extract.batcher import Batch as JaxBatch
from stutter_tpu.extract.pipeline import cast_params_for_preset
from stutter_tpu.models import wavlm as jw
from stutter_tpu.models import whisper as jwh
from stutter_tpu.ops import quant as jq
from stutter_tpu_torch.cli import extract_wavlm as wavlm_cli
from stutter_tpu_torch.cli import extract_whisper as whisper_cli
from stutter_tpu_torch.extract.batcher import Batch, BucketBatcher
from stutter_tpu_torch.extract.pipeline import (
    ExtractionPipeline,
    WavLMExtractor,
    WhisperExtractor,
    cast_for_preset,
)
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.models import wavlm as tw
from stutter_tpu_torch.models import whisper as twh
from stutter_tpu_torch.ops import quant as tq
from stutter_tpu_torch.weights.convert import (
    _LAYER_KEYS,
    _whisper_layer_name,
    init_wavlm,
    init_whisper,
    wavlm_params_from_numpy,
    whisper_params_from_numpy,
)
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

TURBO_VS_F32 = 2e-2
TURBO_VS_JAX_TURBO = 1e-3


def _bf16_pair(rng, shape, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    a = jnp.asarray(rng.randn(*shape).astype(np.float32) * scale, jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("shape", [(64, 32), (1024, 1024), (4096, 1024)])
def test_quantize_weight_bit_equal_to_jax(rng, shape):
    """JAX quantizes [K, N] over K; the port [N, K] over its last axis."""
    jw_, tw_ = _bf16_pair(rng, shape, 0.05)
    ref = jq.quantize_weight(jw_)
    q, s = tq.quantize_weight(tw_.t())
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref["q"]).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["s"]))


@pytest.mark.parametrize("M", [3, 16, 17, 160])
def test_qdot_bit_equal_to_jax(rng, M):
    """The quantized activations, the int32 accumulators and the f32 result."""
    jw_, tw_ = _bf16_pair(rng, (256, 96), 0.05)
    jx, tx = _bf16_pair(rng, (M, 256))
    jqw = jq.quantize_weight(jw_)
    q, s = tq.quantize_weight(tw_.t())
    xf = jx.astype(jnp.float32)
    st = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-8)
    jxq = jnp.clip(jnp.round(xf / st), -127, 127).astype(jnp.int8)
    jacc = jax.lax.dot_general(jxq, jqw["q"], (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    txf = tx.float()
    tst = (txf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    txq = torch.clamp(torch.round(txf / tst), -127, 127).to(torch.int8)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    acc = tq.int_mm(txq, q.t())
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tq.qdot(tx, q, s).numpy(),
                                  np.asarray(jq.qdot(jx, jqw["q"], jqw["s"])))


@pytest.mark.parametrize("M", [1, 5, 16])
def test_int_mm_zero_row_padding_is_exact(rng, M):
    a = torch.from_numpy(rng.randint(-127, 128, size=(M, 64)).astype(np.int8))
    b = torch.from_numpy(rng.randint(-127, 128, size=(64, 24)).astype(np.int8))
    out = tq.int_mm(a, b)
    assert out.shape == (M, 24) and out.dtype == torch.int32
    assert torch.equal(out.long(), a.long() @ b.long())


def test_linear_dispatch(rng):
    _, x = _bf16_pair(rng, (2, 5, 64))
    _, w = _bf16_pair(rng, (32, 64), 0.1)
    _, b = _bf16_pair(rng, (32,), 0.1)
    qw = tq.QuantizedWeight(*tq.quantize_weight(w))
    before = tq.qdot.calls
    got = tq.linear(x, qw, b)
    assert tq.qdot.calls == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (2, 5, 32)
    # the int8 result is cast to bf16 first, then the bias is added
    assert torch.equal(got, tq.qdot(x, qw.q, qw.s).to(torch.bfloat16) + b)
    plain = tq.linear(x, w, b)
    assert tq.qdot.calls == before + 2
    rel = (got.float() - plain.float()).norm() / plain.float().norm()
    assert rel < 0.05
    assert torch.equal(tq.linear(x, w), torch.nn.functional.linear(x, w))


def _quantized_jax_keys(params, block) -> set[str]:
    layers = params[block]["layers"]
    return {k for k, v in layers.items() if isinstance(v, dict)}


def _quantized_port_names(model_layers) -> set[str]:
    names = set()
    for name, module in model_layers[0].named_modules():
        if isinstance(module, tq.QuantizedWeight):
            names.add(name)
    return names


@pytest.mark.parametrize("preset", ["turbo", "turbo_ffn"])
def test_wavlm_preset_quantizes_the_jax_keys(preset):
    cfg = tw.WavLMConfig.tiny()
    jparams = cast_params_for_preset(
        jw.init_wavlm_params(jax.random.key(0), jw.WavLMConfig.tiny()), preset)
    model = cast_for_preset(init_wavlm(cfg, torch.Generator().manual_seed(0)), "cpu", preset)
    to_port = {key: name for key, (name, _) in _LAYER_KEYS.items()}
    assert _quantized_port_names(model.layers) == {
        to_port[k] for k in _quantized_jax_keys(jparams, "encoder")}
    for layer in model.layers:
        assert all(p.dtype == torch.bfloat16 for p in layer.parameters())
        for module in layer.modules():
            if isinstance(module, tq.QuantizedWeight):  # no float copy is kept
                assert module.q.dtype == torch.int8 and module.s.dtype == torch.float32
    assert model.feature_encoder.layers[0].weight.dtype == torch.bfloat16


@pytest.mark.parametrize("preset", ["turbo", "turbo_ffn"])
def test_whisper_preset_quantizes_the_jax_keys(preset):
    cfg = twh.WhisperConfig.tiny()
    jparams = cast_params_for_preset(
        jwh.init_whisper_params(jax.random.key(0), jwh.WhisperConfig.tiny()), preset)
    model = cast_for_preset(init_whisper(cfg, torch.Generator().manual_seed(0)), "cpu", preset)
    assert _quantized_port_names(model.encoder.layers) == {
        _whisper_layer_name(k) for k in _quantized_jax_keys(jparams, "encoder")}
    # the decoder stays bf16 in both
    assert not _quantized_jax_keys(jparams, "decoder")
    assert not any(isinstance(m, tq.QuantizedWeight) for m in model.decoder.modules())
    assert model.decoder.embed_tokens.dtype == torch.bfloat16


def _perturbed(tree_fn, seed):
    r = np.random.RandomState(seed)

    def perturb(a):
        a = np.asarray(a)
        if np.all(a == a.flat[0]):
            a = a + (0.1 * r.randn(*a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(perturb, tree_fn())


def _batch(cls, waves, lengths, bucket_s):
    n = len(waves)
    return cls(paths=[f"clip{i}.wav" for i in range(n)], rows=list(range(n)), waves=waves,
               lengths=np.asarray(lengths, np.int64), ok=np.ones(n, bool), bucket_s=bucket_s)


def _worst(ours: dict, ref: dict) -> float:
    assert sorted(ours) == sorted(ref)
    return max(cosine_distance(ours[c][b], ref[c][b]) for c in ref for b in range(len(ref[c])))


def test_wavlm_turbo_large_matches_jax():
    """WavLM-Large widths, 2 layers, clips of 1 s and 0.6 s."""
    cfg = dataclasses.replace(tw.WavLMConfig.large(), num_hidden_layers=2)
    jcfg = jw.WavLMConfig(**dataclasses.asdict(cfg))
    tree = _perturbed(lambda: jw.init_wavlm_params(jax.random.key(1), jcfg), 1)
    r = np.random.RandomState(2)
    waves = (r.randn(2, 16000) * 0.1).astype(np.float32)
    lengths = [16000, 9600]
    waves[1, 9600:] = 0.0
    jparams = jax.tree.map(jnp.asarray, tree)
    f32 = JaxWavLMExtractor(jcfg, jparams, preset="fidelity")(
        _batch(JaxBatch, waves, lengths, 1.0))
    jturbo = JaxWavLMExtractor(jcfg, jparams, preset="turbo")(
        _batch(JaxBatch, waves, lengths, 1.0))
    model = tw.WavLMModel(cfg)
    model.load_state_dict(wavlm_params_from_numpy(tree, cfg), strict=True)
    ex = WavLMExtractor(model, "cpu", preset="turbo")
    before = tq.qdot.calls
    ours = ex(_batch(Batch, waves, lengths, 1.0))
    assert tq.qdot.calls - before == 6 * cfg.num_hidden_layers
    assert all(np.isfinite(a).all() and a.shape == (2, 1024) for a in ours.values())
    d_f32, d_turbo = _worst(ours, f32), _worst(ours, jturbo)
    print(f"WavLM turbo: port vs JAX f32 {d_f32:.3e}, port vs JAX turbo {d_turbo:.3e}, "
          f"JAX turbo vs JAX f32 {_worst(jturbo, f32):.3e}")
    assert d_f32 <= TURBO_VS_F32 and d_turbo <= TURBO_VS_JAX_TURBO


def test_whisper_turbo_large_matches_jax():
    """Whisper-large widths, 2 encoder and 2 decoder layers, one 2 s clip."""
    cfg = dataclasses.replace(twh.WhisperConfig.large(), encoder_layers=2, decoder_layers=2)
    jcfg = jwh.WhisperConfig(**dataclasses.asdict(cfg))
    tree = _perturbed(lambda: jwh.init_whisper_params(jax.random.key(3), jcfg), 3)
    r = np.random.RandomState(4)
    waves = np.zeros((1, 480_000), np.float32)
    t = np.arange(32_000) / 16000.0
    waves[0, :32_000] = 0.1 * r.randn(32_000) + 0.2 * np.sin(2 * np.pi * 220.0 * t)
    jparams = jax.tree.map(jnp.asarray, tree)
    f32 = JaxWhisperExtractor(jcfg, jparams, preset="fidelity")(
        _batch(JaxBatch, waves, [32_000], 30.0))
    jturbo = JaxWhisperExtractor(jcfg, jparams, preset="turbo")(
        _batch(JaxBatch, waves, [32_000], 30.0))
    model = twh.WhisperModel(cfg)
    model.load_state_dict(whisper_params_from_numpy(tree, cfg), strict=True)
    ex = WhisperExtractor(model, "cpu", preset="turbo")
    before = tq.qdot.calls
    ours = ex(_batch(Batch, waves, [32_000], 30.0))
    assert tq.qdot.calls - before == 5 * cfg.encoder_layers  # none in the decoder
    assert all(np.isfinite(a).all() and a.shape == (1, 1280) for a in ours.values())
    d_f32, d_turbo = _worst(ours, f32), _worst(ours, jturbo)
    print(f"Whisper turbo: port vs JAX f32 {d_f32:.3e}, port vs JAX turbo {d_turbo:.3e}, "
          f"JAX turbo vs JAX f32 {_worst(jturbo, f32):.3e}")
    assert d_f32 <= TURBO_VS_F32 and d_turbo <= TURBO_VS_JAX_TURBO


@pytest.mark.parametrize("model", ["wavlm", "whisper"])
def test_turbo_pipeline_end_to_end(tmp_path, model):
    """A tiny turbo ExtractionPipeline.run writes a finite store."""
    root = tmp_path / "corpus"
    make_synthetic_corpus(str(root), n_per_split={"train": 4 if model == "wavlm" else 3})
    if model == "wavlm":
        ex = WavLMExtractor(init_wavlm(tw.WavLMConfig.tiny(), torch.Generator().manual_seed(0)),
                            "cpu", preset="turbo")
        batcher = BucketBatcher(buckets_s=(2.0, 4.0), audio_budget_s=16.0,
                                frame_align=ex.frame_align)
        n_cols = 3  # [N-1, N-2, N-3, N//2] of a 2-layer model: 3 distinct
    else:
        ex = WhisperExtractor(init_whisper(twh.WhisperConfig.tiny(),
                                           torch.Generator().manual_seed(0)),
                              "cpu", preset="turbo")
        batcher = BucketBatcher(buckets_s=(30.0,), audio_budget_s=90.0)
        n_cols = 6
    out = tmp_path / "emb"
    ExtractionPipeline(ex, batcher=batcher).run(create_metadata_from_files(str(root)),
                                                str(out))
    assert (out / "train" / "embedding_metadata.csv").exists()
    npys = list((out / "train").glob("*_embeddings.npy"))
    assert len(npys) == n_cols
    for f in npys:
        assert np.isfinite(np.load(f)).all()


@pytest.mark.parametrize("cli", ["wavlm", "whisper"])
def test_cli_takes_turbo(tmp_path, cli):
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 2, "test": 1, "devel": 1},
                          duration_range=(0.3, 0.6), seed=1)
    out = str(tmp_path / "out")
    if cli == "wavlm":
        rc = wavlm_cli.main(["--data_dir", root, "--output_dir", out, "--random_init",
                             "--model_name", "microsoft/wavlm-base", "--device", "cpu",
                             "--preset", "turbo", "--audio_budget", "2", "--batch_size", "2"])
        cols, dim = ("layer_12", "layer_11", "layer_10", "layer_6"), 768
    else:
        rc = whisper_cli.main(["--data_dir", root, "--output_dir", out, "--random_init",
                               "--model_name", "openai/whisper-tiny", "--device", "cpu",
                               "--preset", "turbo", "--batch_size", "2"])
        cols, dim = ("encoder_layer_4", "decoder_layer_2"), 384
    assert rc == 0
    for split, n in (("train", 2), ("test", 1), ("devel", 1)):
        for col in cols:
            arr = np.load(os.path.join(out, split, f"{col}_embeddings.npy"))
            assert arr.shape == (n, dim) and np.isfinite(arr).all()


def test_unknown_preset_raises():
    with pytest.raises(ValueError, match="unknown preset"):
        WavLMExtractor(init_wavlm(tw.WavLMConfig.tiny(), torch.Generator().manual_seed(0)),
                       "cpu", preset="int4")


@pytest.mark.parametrize("entry", ["profile_wavlm", "profile_whisper"])
def test_card_clis_take_turbo_and_need_a_card(monkeypatch, entry):
    """The profilers take --preset turbo and, with no card, refuse to run
    rather than fall back to the CPU."""
    import importlib

    cli = importlib.import_module(f"stutter_tpu_torch.cli.{entry}")
    assert cli.parse_args(["--preset", "turbo"]).preset == "turbo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--preset", "turbo"])
