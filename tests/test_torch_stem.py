"""The port's fused WavLM stem against the JAX package's, on the CPU.

The JAX side runs its Pallas kernel (``wavlm_fused_stem``) in interpret mode,
as tests/test_stem_pallas.py does; the port's CPU path runs the wrapper's
plain version, ``wavlm_fused_stem_reference``. The CUDA kernels run only on
the card: chip_smoke.py holds them against that plain version there.

Bars (those of tests/test_stem_pallas.py:98-102): cosine distance <= 5e-4
and nrmse <= 0.03 on the stem frames. Both versions share the rounding
points (conv -> bf16, bias in bf16, f32 LN statistics, tanh GELU on bf16)
but sum in another order, and one flipped bf16 rounding propagates through
seven layer norms. Padded frames are exactly 0 after end-masking. The
encode bar is the repo's 1e-3 pooled cosine distance.

Which calls take the fused stem with no flag set: ``encode`` and
``forward`` wherever the gate passes, never ``pooled_states``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stutter_tpu.ops.wavlm_stem_pallas as jstem
from stutter_tpu.frontend.wavlm_frontend import wavlm_prepare_batch as jax_prepare
from stutter_tpu.models import wavlm as jw
from stutter_tpu_torch.audio.wavio import write_wav
from stutter_tpu_torch.extract.batcher import BucketBatcher
from stutter_tpu_torch.extract.pipeline import WavLMExtractor
from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
from stutter_tpu_torch.models import wavlm as tw
from stutter_tpu_torch.ops import wavlm_stem as tstem
from stutter_tpu_torch.ops.quant import QuantizedWeight, quantize_weight
from stutter_tpu_torch.weights.convert import init_wavlm, wavlm_params_from_numpy
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

STEM_COSINE, STEM_NRMSE = 5e-4, 0.03
ENCODE_COSINE = 1e-3
C = 128
CFG = tw.WavLMConfig(conv_dim=(C,) * 7, conv_bias=True, feat_extract_norm="layer")


def _jax_cfg(cfg: tw.WavLMConfig) -> jw.WavLMConfig:
    return jw.WavLMConfig(**dataclasses.asdict(cfg))


def _jax_layers(rng):
    """The conv layers of tests/test_stem_pallas.py:_make_layers, as numpy."""
    layers, in_dim = [], 1
    for i, out_dim in enumerate(CFG.conv_dim):
        k = CFG.conv_kernel[i]
        layers.append({
            "w": rng.randn(out_dim, in_dim, k).astype(np.float32) * (in_dim * k) ** -0.5,
            "b": rng.randn(out_dim).astype(np.float32) * 0.1,
            "norm": {"scale": 1.0 + 0.1 * rng.randn(out_dim).astype(np.float32),
                     "bias": 0.1 * rng.randn(out_dim).astype(np.float32)},
        })
        in_dim = out_dim
    return layers


def _port_stem(cfg, layers) -> tw.ConvFeatureEncoder:
    stem = tw.ConvFeatureEncoder(cfg)
    with torch.no_grad():
        for mod, p in zip(stem.layers, layers):
            mod.weight.copy_(torch.from_numpy(p["w"]))
            mod.bias.copy_(torch.from_numpy(p["b"]))
            mod.norm_scale.copy_(torch.from_numpy(p["norm"]["scale"]))
            mod.norm_bias.copy_(torch.from_numpy(p["norm"]["bias"]))
    return stem


def _masked(frames: np.ndarray, frame_lengths) -> np.ndarray:
    keep = np.arange(frames.shape[1])[None, :] < np.asarray(frame_lengths)[:, None]
    return frames * keep[:, :, None]


def test_reference_matches_jax_pallas_stem(rng):
    """C = 128, L = 32 (two 16-frame blocks), B = 2, ragged lengths."""
    L, B = 32, 2
    T = L * 320 + 80
    layers = _jax_layers(rng)
    wave = rng.randn(B, T).astype(np.float32) * 0.1
    lengths = np.array([T, T - 1600])
    ref = np.asarray(jstem.wavlm_fused_stem(
        jnp.asarray(wave), jax.tree.map(jnp.asarray, layers), interpret=True), np.float32)
    stem = _port_stem(CFG, layers)
    ours = tstem.wavlm_fused_stem(torch.from_numpy(wave), *stem.packed())
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == ref.shape == (B, L, C)
    fl = tw.wavlm_feature_lengths(CFG, lengths)
    assert int(fl[1]) < L
    f, r = _masked(ours.float().numpy(), fl), _masked(ref, fl)
    assert np.all(f[1, int(fl[1]):] == 0)
    nrmse = np.linalg.norm(f - r) / np.linalg.norm(r)
    cos = cosine_distance(f, r)
    print(f"port plain stem vs JAX Pallas stem: nrmse {nrmse:.3e}, cosine {cos:.3e}")
    assert nrmse <= STEM_NRMSE and cos <= STEM_COSINE


def test_reference_matches_plain_stem_on_valid_frames(rng):
    """The fused function equals ConvFeatureEncoder's bf16 path on every
    frame of a clip (the per-frame layer norm leaves padding out of the
    statistics), at WavLM-Large's 512 channels."""
    cfg = tw.WavLMConfig.large()
    stem = _port_stem(cfg, [
        {"w": rng.randn(512, 1 if i == 0 else 512, k).astype(np.float32)
         * ((1 if i == 0 else 512) * k) ** -0.5,
         "b": rng.randn(512).astype(np.float32) * 0.1,
         "norm": {"scale": 1.0 + 0.1 * rng.randn(512).astype(np.float32),
                  "bias": 0.1 * rng.randn(512).astype(np.float32)}}
        for i, k in enumerate(cfg.conv_kernel)]).to(torch.bfloat16)
    T = 16 * 320 + 80
    wave = torch.from_numpy(rng.randn(2, T).astype(np.float32) * 0.1)
    lengths = torch.tensor([T, 3000])
    wave[1, 3000:] = 0
    plain = stem(wave, lengths).float().numpy()
    fl = tw.wavlm_feature_lengths(cfg, lengths.numpy())
    fused = _masked(tstem.wavlm_fused_stem(wave, *stem.packed()).float().numpy(), fl)
    assert cosine_distance(fused, plain) <= STEM_COSINE
    assert np.linalg.norm(fused - plain) / np.linalg.norm(plain) <= STEM_NRMSE


def test_pack_layout(rng):
    layers = _jax_layers(rng)
    stem = _port_stem(CFG, layers)
    weights, table = tstem.pack_stem_weights(stem.layers)
    assert weights.dtype == torch.bfloat16 and tuple(weights.shape) == (16 + 4 * 3 * C
                                                                      + 2 * 2 * C, C)
    assert table.dtype == torch.float32 and tuple(table.shape) == (7, 3, C)
    w0 = weights[:16].float().numpy()
    np.testing.assert_array_equal(w0[10:], 0)
    # layer 0, tap j, output n: W[n, 0, j]
    ref0 = torch.from_numpy(layers[0]["w"]).bfloat16().float().numpy()
    np.testing.assert_array_equal(w0[:10], ref0[:, 0, :].T)
    # layer 1: K-major wgmma tiles [passes][chunks][C][64]; row n of tile
    # (0, c) holds W[n, c', j] for the contraction index j * C + c' in
    # 64 c .. 64 c + 63, its 16-byte group g stored at g ^ (n % 8)
    tiles = weights[16:16 + 3 * C].float().numpy().reshape(3 * C // 64, C, 8, 8)
    ref1 = torch.from_numpy(layers[1]["w"]).bfloat16().float().numpy()
    wt = ref1.transpose(0, 2, 1).reshape(C, 3 * C)  # [n, j * C + c']
    for c in range(3 * C // 64):
        for n in range(C):
            for g in range(8):
                np.testing.assert_array_equal(tiles[c, n, g ^ (n % 8)],
                                              wt[n, 64 * c + 8 * g:64 * c + 8 * g + 8])
    np.testing.assert_array_equal(table[3, 1].numpy(), layers[3]["norm"]["scale"])


def test_pack_is_cached_until_the_weights_change(rng):
    stem = _port_stem(CFG, _jax_layers(rng))
    first = stem.packed()
    assert stem.packed() is first
    stem.to(torch.bfloat16)
    second = stem.packed()
    assert second is not first and stem.packed() is second
    with torch.no_grad():
        stem.layers[2].norm_bias.add_(1.0)
    third = stem.packed()
    assert third is not second
    assert torch.equal(third[1][2, 2], stem.layers[2].norm_bias.float())


def _applicable_both(cfg, T, jlayers, tlayers) -> tuple[bool, bool]:
    return (jstem.fused_stem_applicable(_jax_cfg(cfg), T, jlayers),
            tstem.fused_stem_applicable(cfg, T, tlayers))


@pytest.mark.parametrize("case", ["aligned", "group_norm", "l17", "dangling_sample",
                                  "quantized", "tiny_geometry", "too_short"])
def test_applicability_matches_jax(rng, case):
    """The cases of tests/test_stem_pallas.py:105-120, plus L < 16."""
    jlayers = jax.tree.map(jnp.asarray, _jax_layers(rng))
    tlayers = _port_stem(CFG, _jax_layers(np.random.RandomState(0))).layers
    cfg, T = CFG, 16 * 320 + 80
    if case == "group_norm":
        cfg = tw.WavLMConfig(conv_dim=(C,) * 7, conv_bias=True)
    elif case == "l17":
        T += 320
    elif case == "dangling_sample":
        T += 1
    elif case == "quantized":
        jlayers = [dict(jlayers[0], w={"q": None, "s": None})] + jlayers[1:]
        layer0 = tlayers[0]
        w = layer0._parameters.pop("weight")
        layer0.weight = QuantizedWeight(*quantize_weight(w.detach().flatten(1)))
    elif case == "tiny_geometry":
        cfg = tw.WavLMConfig.tiny()
    elif case == "too_short":
        T = 8 * 320 + 80
    jax_says, port_says = _applicable_both(cfg, T, jlayers, tlayers)
    assert port_says == jax_says == (case == "aligned")


@pytest.mark.parametrize("width,device,supported", [
    (512, "cuda", True), (128, "cuda", False), (256, "cuda", False),
    (128, "cpu", True), (512, "cpu", True)])
def test_kernel_width_decides_the_card_path(width, device, supported):
    """The gate passes any width that is a multiple of 128; on the card only
    the kernel's 512 runs fused, and another width keeps the plain stem
    instead of reaching the wrapper's ValueError."""
    cfg = tw.WavLMConfig(conv_dim=(width,) * 7, conv_bias=True, feat_extract_norm="layer")
    assert tstem.fused_stem_supported(cfg, torch.device(device)) is supported


@pytest.fixture(scope="module")
def large_two_layers_bf16():
    """WavLM-Large widths, 2 layers, the same weights in both packages, cast
    to bf16 as the fast preset casts them (constant leaves perturbed)."""
    cfg = dataclasses.replace(tw.WavLMConfig.large(), num_hidden_layers=2)
    r = np.random.RandomState(5)

    def perturb(a):
        a = np.asarray(a)
        if np.all(a == a.flat[0]):
            a = a + (0.1 * r.randn(*a.shape)).astype(a.dtype)
        return a

    tree = jax.tree.map(perturb, jw.init_wavlm_params(jax.random.key(5), _jax_cfg(cfg)))
    model = tw.WavLMModel(cfg)
    model.load_state_dict(wavlm_params_from_numpy(tree, cfg), strict=True)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    return cfg, jparams, model


def _encode_both(cfg, jparams, model, T, lengths, monkeypatch, dtype):
    """Pooled embeddings of both packages with use_fused_stem=True, and how
    often each took its fused stem."""
    calls = {"jax": 0, "port": 0}
    interp = functools.partial(jstem.wavlm_fused_stem, interpret=True)

    def jax_spy(*a, **kw):
        calls["jax"] += 1
        return interp(*a, **kw)

    real = tw.wavlm_fused_stem

    def port_spy(*a, **kw):
        calls["port"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(jstem, "wavlm_fused_stem", jax_spy)
    monkeypatch.setattr(tw, "wavlm_fused_stem", port_spy)
    r = np.random.RandomState(6)
    w = (r.randn(2, T) * 0.1).astype(np.float32)
    w[1, lengths[1]:] = 0.0
    layers = (2, 1, 0, 1)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = jparams if dtype == torch.bfloat16 else jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), jparams)
    jin = jax_prepare(jnp.asarray(w), jnp.asarray(lengths), cfg.do_normalize)
    ref = np.asarray(jw.wavlm_encode(jp, jin, _jax_cfg(cfg), layers, jnp.asarray(lengths),
                                     precision=jax.lax.Precision.DEFAULT,
                                     activation_dtype=jdtype, use_fused_stem=True))
    m = model.to(dtype)
    lens = torch.from_numpy(lengths).long()
    ours = m.encode(wavlm_prepare_batch(torch.from_numpy(w), lens, cfg.do_normalize), layers,
                    lens, use_fused_stem=True).numpy()
    return ours, ref, calls


def test_fused_encode_matches_jax(large_two_layers_bf16, monkeypatch):
    """Both packages' encode(use_fused_stem=True) on a frame-aligned 16-frame
    bucket with a ragged second clip, bf16."""
    cfg, jparams, model = large_two_layers_bf16
    T = 16 * 320 + 80
    ours, ref, calls = _encode_both(cfg, jparams, model, T, np.array([T, 3600]),
                                    monkeypatch, torch.bfloat16)
    assert calls == {"jax": 1, "port": 1}
    assert np.isfinite(ours).all() and ours.shape == ref.shape == (4, 2, 1024)
    worst = max(cosine_distance(ours[s, b], ref[s, b]) for s in range(4) for b in range(2))
    print(f"fused encode, port vs JAX (both bf16): pooled cosine distance {worst:.3e}")
    assert worst <= ENCODE_COSINE


@pytest.mark.parametrize("case", ["f32_params", "unaligned_length"])
def test_fused_stem_skipped_like_jax(large_two_layers_bf16, monkeypatch, case):
    """f32 parameters and a length off the 16-frame grid take the plain stem
    in both packages."""
    cfg, jparams, model = large_two_layers_bf16
    T = 16 * 320 + 80 + (320 if case == "unaligned_length" else 0)
    dtype = torch.float32 if case == "f32_params" else torch.bfloat16
    ours, ref, calls = _encode_both(cfg, jparams, model, T, np.array([T, 3600]),
                                    monkeypatch, dtype)
    assert calls == {"jax": 0, "port": 0}
    assert np.isfinite(ours).all() and ours.shape == ref.shape


def test_cpu_wrapper_leaves_launches_at_zero(rng):
    stem = _port_stem(CFG, _jax_layers(rng)).to(torch.bfloat16)
    tstem.wavlm_fused_stem.launches = 0
    tstem.wavlm_fused_stem(torch.zeros(1, 5200), *stem.packed())
    assert tstem.wavlm_fused_stem.launches == 0
    with pytest.raises(ValueError, match="no kernel"):
        tstem.wavlm_fused_stem(torch.zeros(1, 5200, device="meta"), *stem.packed())


@pytest.mark.parametrize("fault", ["channels", "short_wave", "wave_dtype", "table_dtype"])
def test_kernel_input_checks(fault):
    rows = 16 + 4 * 1536 + 2 * 1024
    wave = torch.zeros(2, 5200)
    weights = torch.zeros(rows, 512, dtype=torch.bfloat16)
    table = torch.zeros(7, 3, 512)
    if fault == "channels":
        weights = torch.zeros(16 + 4 * 384 + 2 * 256, 128, dtype=torch.bfloat16)
    elif fault == "short_wave":
        wave = torch.zeros(2, 399)
    elif fault == "wave_dtype":
        wave = wave.half()
    else:
        table = table.double()
    with pytest.raises(ValueError):
        tstem._check(wave, weights, table)
    tstem._check(torch.zeros(2, 5200), torch.zeros(rows, 512, dtype=torch.bfloat16),
                 torch.zeros(7, 3, 512))


# WavLM-Large's stem geometry and norms at a 128-wide stem, with a small
# encoder: what the gate reads, at a size the CPU runs in a second
SMALL = dataclasses.replace(tw.WavLMConfig.large(), hidden_size=64, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=128, conv_dim=(C,) * 7)
ALIGNED = 16 * 320 + 80  # one 16-frame block


@pytest.fixture
def stem_calls(monkeypatch):
    """The waveforms that ``models.wavlm`` hands its fused stem."""
    calls = []
    real = tw.wavlm_fused_stem

    def spy(waveform, *args):
        calls.append(tuple(waveform.shape))
        return real(waveform, *args)

    monkeypatch.setattr(tw, "wavlm_fused_stem", spy)
    return calls


def _small_model(dtype):
    return init_wavlm(SMALL, torch.Generator().manual_seed(3)).to(dtype)


@pytest.mark.parametrize("case,fused", [
    ("encode", True), ("forward", True), ("f32_params", False), ("unaligned_length", False),
    ("use_fused_stem_false", False), ("pooled_states", False),
    ("pooled_states_stop_stem_gradient", False)])
def test_stem_selection_follows_the_gate(stem_calls, case, fused):
    """Without a flag, encode and forward take the fused stem once a call on
    a frame-aligned bf16 batch; f32 weights, an unaligned length and
    use_fused_stem=False keep the plain stem, and so does the
    differentiable pooled_states, with or without its stem's gradient."""
    model = _small_model(torch.float32 if case == "f32_params" else torch.bfloat16)
    T = ALIGNED + (320 if case == "unaligned_length" else 0)
    r = np.random.RandomState(7)
    lens = torch.tensor([T, 3600])
    w = wavlm_prepare_batch(torch.from_numpy((r.randn(2, T) * 0.1).astype(np.float32)), lens,
                            SMALL.do_normalize)
    if case == "forward":
        out = model(w, lens)[1]
    elif case.startswith("pooled_states"):
        out = model.pooled_states(w, lens, stop_stem_gradient=case.endswith("gradient"))
    else:
        out = model.encode(w, (2, 1), lens, **(
            {"use_fused_stem": False} if case == "use_fused_stem_false" else {}))
    assert torch.isfinite(out.float()).all()
    assert stem_calls == ([(2, T)] if fused else [])
    if case == "encode":  # the default is the fused path itself
        explicit = model.encode(w, (2, 1), lens, use_fused_stem=True)
        assert torch.equal(out, explicit)


def test_fast_extractor_takes_the_fused_stem(stem_calls, tmp_path):
    """A fast-preset WavLMExtractor batch from the frame-aligned batcher."""
    r = np.random.RandomState(8)
    paths = []
    for i, n in enumerate((9_000, 14_000)):
        paths.append(str(tmp_path / f"clip{i}.wav"))
        write_wav(paths[-1], (r.randn(n) * 0.1).astype(np.float32), 16_000)
    ex = WavLMExtractor(_small_model(torch.float32), "cpu", layer_indices=(2, 1),
                        preset="fast")
    batcher = BucketBatcher(buckets_s=(1.0,), max_batch=4, frame_align=ex.frame_align)
    batches = list(batcher.batches(paths, prefetch=False))
    rows = [ex(b) for b in batches]
    n = batcher.bucket_samples(1.0)
    assert tstem.fused_stem_applicable(SMALL, n, ex.model.feature_encoder.layers)
    assert stem_calls == [b.waves.shape for b in batches] == [(4, n)]
    assert all(np.isfinite(v).all() for row in rows for v in row.values())
