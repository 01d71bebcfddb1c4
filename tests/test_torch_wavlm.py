"""stutter_tpu_torch's WavLM against the JAX package, on the CPU.

The same numpy inputs (from np.random.RandomState) and the same parameters
(init_wavlm_params turned into numpy, then wavlm_params_from_numpy) go
through both packages. f32 comparisons use JAX Precision.HIGHEST; the port's
CPU path runs the attention wrapper's plain version, and the Pallas kernels
run in interpret mode as tests/test_pallas_kernels.py runs them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stutter_tpu.frontend.wavlm_frontend import wavlm_prepare_batch as jax_prepare
from stutter_tpu.models import wavlm as jw
from stutter_tpu.ops.pooling import masked_mean_pool as jax_pool
from stutter_tpu.ops.wavlm_attention_pallas import (
    wavlm_fused_attention,
    wavlm_fused_attention_long,
)
from stutter_tpu_torch.extract.pipeline import WavLMExtractor
from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
from stutter_tpu_torch.models import wavlm as tw
from stutter_tpu_torch.ops import wavlm_attention as tattn
from stutter_tpu_torch.ops.pooling import masked_mean_pool
from stutter_tpu_torch.weights.convert import init_wavlm, wavlm_params_from_numpy
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

HIGHEST = jax.lax.Precision.HIGHEST


def _jax_cfg(cfg: tw.WavLMConfig) -> jw.WavLMConfig:
    return jw.WavLMConfig(**dataclasses.asdict(cfg))


def _both(cfg: tw.WavLMConfig, seed: int = 0):
    """(JAX params, port f32 model) holding the same weights.

    init_wavlm_params makes every bias zero and every norm scale one, which
    would hide a wrong bias or a missing mask; those constant leaves get
    seeded noise here."""
    r = np.random.RandomState(seed)

    def perturb(a):
        a = np.asarray(a)
        if np.all(a == a.flat[0]):
            a = a + (0.1 * r.randn(*a.shape)).astype(a.dtype)
        return a

    tree = jax.tree.map(perturb, jw.init_wavlm_params(jax.random.key(seed), _jax_cfg(cfg)))
    model = tw.WavLMModel(cfg)
    model.load_state_dict(wavlm_params_from_numpy(tree, cfg), strict=True)
    return jax.tree.map(jnp.asarray, tree), model


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("preset", ["base", "base_plus", "large", "tiny"])
def test_config_matches_jax(preset):
    ours, ref = getattr(tw.WavLMConfig, preset)(), getattr(jw.WavLMConfig, preset)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert ours.head_dim == ref.head_dim
    assert ours.stem_geometry == ref.stem_geometry


@pytest.mark.parametrize("L", [1, 49, 160, 639, 1504])
def test_relative_position_buckets_exact(L):
    ours = tw.relative_position_buckets(L, 320, 800)
    ref = jw.relative_position_buckets(L, 320, 800)
    assert ours.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)


def test_feature_lengths_match_jax():
    cfg = tw.WavLMConfig.large()
    n = np.array([400, 9600, 16000, 51280, 481_280])
    np.testing.assert_array_equal(tw.wavlm_feature_lengths(cfg, _t(n)).numpy(),
                                  np.asarray(jw.wavlm_feature_lengths(_jax_cfg(cfg), n)))
    assert tw.wavlm_feature_lengths(cfg, 51280) == 160


def test_pooling_matches_jax(rng):
    h = rng.randn(3, 17, 8).astype(np.float32)
    lengths = np.array([17, 5, 0], np.int32)
    ours = masked_mean_pool(_t(h), _t(lengths)).numpy()
    ref = np.asarray(jax_pool(jnp.asarray(h), jnp.asarray(lengths)))
    np.testing.assert_allclose(ours, ref, atol=1e-6)


@pytest.mark.parametrize("do_normalize", [True, False])
def test_frontend_matches_jax(rng, do_normalize):
    w = (rng.randn(3, 800) * 0.3 + 0.05).astype(np.float32)
    lengths = np.array([800, 333, 1], np.int32)
    ours = wavlm_prepare_batch(_t(w), _t(lengths), do_normalize).numpy()
    ref = np.asarray(jax_prepare(jnp.asarray(w), jnp.asarray(lengths), do_normalize))
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def _attention_inputs(rng, B, H, L, d, masked_clip, cut):
    q, k, v = (rng.randn(B, H, L, d).astype(np.float32) * 0.2 for _ in range(3))
    bias = rng.randn(H, L, L).astype(np.float32)
    gate = rng.rand(B, H, L).astype(np.float32)
    mask = np.zeros((B, L), np.float32)
    mask[masked_clip, cut:] = -1e9
    return q, k, v, bias, gate, mask


@pytest.mark.parametrize("kernel", ["short", "long"])
def test_attention_reference_matches_pallas(rng, kernel):
    if kernel == "short":
        args = _attention_inputs(rng, 4, 4, 16, 8, masked_clip=0, cut=10)
        ref = wavlm_fused_attention(*map(jnp.asarray, args), interpret=True)
    else:
        args = _attention_inputs(rng, 2, 3, 32, 8, masked_clip=1, cut=20)
        ref = wavlm_fused_attention_long(*map(jnp.asarray, args), block_q=16, interpret=True)
    ours = tattn.gated_relpos_attention_reference(*map(_t, args))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5)


def _stem_cfg(variant: str) -> tw.WavLMConfig:
    cfg = tw.WavLMConfig.tiny()
    if variant == "layer":
        cfg = dataclasses.replace(cfg, feat_extract_norm="layer", conv_bias=True)
    return cfg


@pytest.mark.parametrize("variant", ["group", "layer"])
def test_stem_matches_jax(rng, variant):
    cfg = _stem_cfg(variant)
    params, model = _both(cfg)
    w = (rng.randn(3, 1600) * 0.3).astype(np.float32)
    lengths = np.array([1600, 1111, 407], np.int32)  # ragged: 79, 54 and 19 frames
    ref = jw.conv_feature_encoder(params["feature_encoder"], jnp.asarray(w), _jax_cfg(cfg),
                                  HIGHEST, sample_lengths=jnp.asarray(lengths))
    ours = model.feature_encoder(_t(w), _t(lengths).long())
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module", params=["post_ln", "stable_pre_ln"])
def tiny_pair(request):
    cfg = dataclasses.replace(tw.WavLMConfig.tiny(),
                              do_stable_layer_norm=request.param == "stable_pre_ln")
    return (cfg, *_both(cfg))


def _tiny_batch():
    # tiny stem: 20x downsampling, so 0.8 s is L = 639 frames
    r = np.random.RandomState(1)
    w = (r.randn(2, 12800) * 0.3).astype(np.float32)
    return w, np.array([12800, 7300], np.int32)


def test_forward_hidden_states_match_jax(tiny_pair):
    cfg, params, model = tiny_pair
    w, lengths = _tiny_batch()
    _, ref, ref_fl = jw.wavlm_forward(params, jnp.asarray(w), _jax_cfg(cfg),
                                      jnp.asarray(lengths), precision=HIGHEST)
    _, ours, fl = model(_t(w), _t(lengths).long())
    assert ours.shape == ref.shape == (cfg.num_hidden_layers + 1, 2, 639, cfg.hidden_size)
    np.testing.assert_array_equal(fl.numpy(), np.asarray(ref_fl))
    ref, ours = np.asarray(ref), ours.numpy()
    for i in range(ref.shape[0]):
        for b in range(2):  # valid frames only: padded frames carry no contract
            n = int(fl[b])
            np.testing.assert_allclose(ours[i, b, :n], ref[i, b, :n], atol=1e-4)
            assert cosine_distance(ours[i, b, :n], ref[i, b, :n]) <= 1e-6


def test_encode_matches_jax(tiny_pair):
    cfg, params, model = tiny_pair
    w, lengths = _tiny_batch()
    layers = (2, 1, 0)
    ref = np.asarray(jw.wavlm_encode(params, jnp.asarray(w), _jax_cfg(cfg), layers,
                                     jnp.asarray(lengths), precision=HIGHEST))
    ours = model.encode(_t(w), layers, _t(lengths).long()).numpy()
    assert ours.shape == ref.shape == (3, 2, cfg.hidden_size) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    for s in range(3):
        for b in range(2):
            assert cosine_distance(ours[s, b], ref[s, b]) <= 1e-6


@pytest.fixture(scope="module")
def large_two_layers():
    """WavLM-Large at full widths, 2 layers; clips of 1 s and 0.6 s."""
    cfg = dataclasses.replace(tw.WavLMConfig.large(), num_hidden_layers=2)
    params, model = _both(cfg)
    r = np.random.RandomState(2)
    w = (r.randn(2, 16000) * 0.1).astype(np.float32)
    lengths = np.array([16000, 9600], np.int32)
    w[1, 9600:] = 0.0
    layers = (2, 1, 0, 1)  # (N, N-1, N-2, (N+1)//2) for N = 2
    jw_in = jax_prepare(jnp.asarray(w), jnp.asarray(lengths), cfg.do_normalize)
    ref = np.asarray(jw.wavlm_encode(params, jw_in, _jax_cfg(cfg), layers,
                                     jnp.asarray(lengths), precision=HIGHEST))
    return cfg, model, w, lengths, layers, ref


@pytest.mark.parametrize("preset,bar", [("fidelity", 1e-5), ("fast", 1e-3)])
def test_full_width_large_matches_jax_f32(large_two_layers, preset, bar):
    cfg, model, w, lengths, layers, ref = large_two_layers
    dtype = torch.float32 if preset == "fidelity" else torch.bfloat16
    m = tw.WavLMModel(cfg, dtype=dtype)
    m.load_state_dict(model.state_dict())  # casts, as the fast preset does
    lens = _t(lengths).long()
    ours = m.encode(wavlm_prepare_batch(_t(w), lens, cfg.do_normalize), layers, lens).numpy()
    dists = [cosine_distance(ours[s, b], ref[s, b])
             for s in range(len(layers)) for b in range(2)]
    print(f"{preset}: port vs JAX f32 pooled cosine distance, max {max(dists):.3e}")
    assert np.isfinite(ours).all()
    assert max(dists) <= bar


def test_batched_equals_per_clip():
    cfg = tw.WavLMConfig.tiny()
    _, model = _both(cfg)
    r = np.random.RandomState(3)
    n = np.array([9000, 4100, 2213])
    w = np.zeros((3, 9000), np.float32)
    for b in range(3):
        w[b, : n[b]] = r.randn(n[b]) * 0.3
    batched = model.encode(_t(w), (2, 1), _t(n)).numpy()
    for b in range(3):
        alone = model.encode(_t(w[b:b + 1, : n[b]]), (2, 1), _t(n[b:b + 1])).numpy()
        np.testing.assert_allclose(batched[:, b], alone[:, 0], atol=1e-5)


def test_converter_uses_every_leaf():
    cfg = tw.WavLMConfig.tiny()
    tree = jax.tree.map(np.asarray, jw.init_wavlm_params(jax.random.key(0), _jax_cfg(cfg)))
    state = wavlm_params_from_numpy(tree, cfg)
    n_tree = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(t.numel() for t in state.values()) == n_tree
    assert set(state) == set(tw.WavLMModel(cfg, device="meta").state_dict())
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="stray"):
        wavlm_params_from_numpy(extra, cfg)
    missing = dict(tree, encoder={k: v for k, v in tree["encoder"].items() if k != "ln"})
    with pytest.raises(KeyError, match="encoder/ln"):
        wavlm_params_from_numpy(missing, cfg)


def test_init_wavlm_is_seeded():
    cfg = tw.WavLMConfig.tiny()
    a = init_wavlm(cfg, torch.Generator().manual_seed(0)).state_dict()
    b = init_wavlm(cfg, torch.Generator().manual_seed(0)).state_dict()
    c = init_wavlm(cfg, torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.0.attention.q_w"], c["layers.0.attention.q_w"])
    assert torch.equal(a["layers.1.ln1_s"], torch.ones(cfg.hidden_size))


def test_cuda_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = init_wavlm(tw.WavLMConfig.tiny(), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WavLMExtractor(model, "cuda")


def test_cpu_wrapper_leaves_launches_at_zero(rng):
    before = tattn.gated_relpos_attention.launches
    args = _attention_inputs(rng, 2, 2, 12, 64, masked_clip=0, cut=7)
    out = tattn.gated_relpos_attention(*map(_t, args))
    assert out.shape == (2, 2, 12, 64)
    model = init_wavlm(tw.WavLMConfig.tiny(), torch.Generator().manual_seed(0))
    model.encode(torch.zeros(1, 4000), (1,))
    assert tattn.gated_relpos_attention.launches == before == 0


@pytest.mark.parametrize("fault", ["head_dim", "dtype", "bias_shape", "gate_dtype", "strides",
                                   "bf16_alignment"])
def test_kernel_input_checks(fault):
    B, H, L, d = 2, 3, 10, 64
    q, k, v = (torch.zeros(B, H, L, d) for _ in range(3))
    bias, gate, mask = torch.zeros(H, L, L), torch.zeros(B, H, L), torch.zeros(B, L)
    if fault == "head_dim":
        q, k, v = (torch.zeros(B, H, L, 32) for _ in range(3))
    elif fault == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif fault == "bias_shape":
        bias = torch.zeros(H, L, L + 1)
    elif fault == "gate_dtype":
        gate = gate.double()
    elif fault == "bf16_alignment":  # rows of 8 bytes offset from a 16-byte boundary
        q, k, v = (torch.zeros(B, H, L * d + 4, dtype=torch.bfloat16)[..., 4:]
                   .view(B, H, L, d) for _ in range(3))
    else:
        k = torch.zeros(B, L, H, d).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        tattn._check(q, k, v, bias, gate, mask)
    if fault == "strides":  # q, k, v in one non-contiguous layout are taken
        q, v = (torch.zeros(B, L, H, d).transpose(1, 2) for _ in range(2))
        tattn._check(q, k, v, bias, gate, mask)
