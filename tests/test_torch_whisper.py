"""stutter_tpu_torch's Whisper extraction against the JAX package, on the CPU.

The same numpy inputs (from np.random.RandomState) and the same parameters
(init_whisper_params turned into numpy, constant leaves perturbed, then
whisper_params_from_numpy) go through both packages. f32 comparisons use JAX
Precision.HIGHEST; the port's CPU path runs the attention wrapper's and the
log-mel wrapper's plain versions (the JAX package's CPU path is its einsum
attention and XLA log-mel). The CUDA kernels run only on the card:
chip_smoke.py holds them against their plain versions there.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stutter_tpu.audio.synthetic import make_synthetic_corpus
from stutter_tpu.extract import (
    ExtractionPipeline as JaxPipeline,
    WhisperExtractor as JaxWhisperExtractor,
    create_metadata_from_files as jax_scan,
)
from stutter_tpu.extract.batcher import Batch as JaxBatch
from stutter_tpu.frontend.whisper_frontend import whisper_features as jax_features
from stutter_tpu.models import attention as jattn
from stutter_tpu.models import whisper as jw
from stutter_tpu_torch.cli import extract_whisper as cli
from stutter_tpu_torch.cli import profile_whisper as profile_cli
from stutter_tpu_torch.extract.batcher import DEFAULT_BUCKETS_S, Batch
from stutter_tpu_torch.extract.pipeline import (
    ExtractionPipeline,
    WavLMExtractor,
    WhisperExtractor,
)
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.models import whisper as tw
from stutter_tpu_torch.models.wavlm import WavLMConfig
from stutter_tpu_torch.ops import flash_mha as tmha
from stutter_tpu_torch.weights.convert import (
    init_wavlm,
    init_whisper,
    whisper_params_from_numpy,
)
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

HIGHEST = jax.lax.Precision.HIGHEST
FIDELITY_BAR = 1e-5  # port f32 vs JAX f32, pooled cosine distance
FAST_BAR = 1e-3      # port bf16 vs JAX f32: the repo's bar


def _jax_cfg(cfg: tw.WhisperConfig) -> jw.WhisperConfig:
    return jw.WhisperConfig(**dataclasses.asdict(cfg))


def _tree(cfg: tw.WhisperConfig, seed: int = 0):
    """init_whisper_params as numpy, with the constant leaves (zero biases,
    unit norm scales) given seeded noise so that a wrong bias or norm shows."""
    r = np.random.RandomState(seed)

    def perturb(a):
        a = np.asarray(a)
        if np.all(a == a.flat[0]):
            a = a + (0.1 * r.randn(*a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(perturb, jw.init_whisper_params(jax.random.key(seed), _jax_cfg(cfg)))


def _port(cfg: tw.WhisperConfig, tree) -> tw.WhisperModel:
    model = tw.WhisperModel(cfg)
    model.load_state_dict(whisper_params_from_numpy(tree, cfg), strict=True)
    return model


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(cls, waves: np.ndarray, lengths):
    n = len(waves)
    return cls(paths=[f"clip{i}.wav" for i in range(n)], rows=list(range(n)), waves=waves,
               lengths=np.asarray(lengths, np.int64), ok=np.ones(n, bool), bucket_s=30.0)


def _clips(seed: int, lengths) -> np.ndarray:
    """30 s windows holding `lengths` samples of noise and tone, zeros after."""
    r = np.random.RandomState(seed)
    w = np.zeros((len(lengths), 480_000), np.float32)
    for b, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        w[b, :n] = 0.1 * r.randn(n) + 0.2 * np.sin(2 * np.pi * r.uniform(100, 600) * t)
    return w


def _max_pooled_distance(ours: dict, ref: dict, n: int) -> float:
    assert sorted(ours) == sorted(ref)
    return max(cosine_distance(ours[c][b], ref[c][b]) for c in ref for b in range(n))


@pytest.mark.parametrize("preset", ["large", "large_v2", "large_v3", "medium", "small",
                                    "base", "tiny_official", "tiny"])
def test_config_matches_jax(preset):
    ours, ref = getattr(tw.WhisperConfig, preset)(), getattr(jw.WhisperConfig, preset)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert ours.head_dim == ref.head_dim


@pytest.mark.parametrize("shape", [(1500, 1280), (1500, 32), (448, 384)])
def test_sinusoids_exact(shape):
    ours, ref = tw.sinusoids(*shape), jw.sinusoids(*shape)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("kv_valid", [None, (37, 20, 0)])
def test_mha_reference_matches_jax_einsum(rng, kv_valid):
    q, k, v = (rng.randn(3, 4, 37, 64).astype(np.float32) * 0.3 for _ in range(3))
    kv = None if kv_valid is None else np.asarray(kv_valid, np.int32)
    ref = jattn.mha_self(*map(jnp.asarray, (q, k, v)),
                         kv_valid=None if kv is None else jnp.asarray(kv),
                         precision=HIGHEST, allow_flash=False)
    ours = tmha.flash_mha_reference(_t(q), _t(k), _t(v), None if kv is None else _t(kv))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    assert np.isfinite(ours.numpy()).all()
    ours = tmha.mha_self(_t(q), _t(k), _t(v), None if kv is None else _t(kv))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def tiny():
    cfg = tw.WhisperConfig.tiny()
    tree = _tree(cfg)
    mel = np.asarray(jax_features(jnp.asarray(_clips(1, [32_000, 9_000]))))
    return cfg, tree, mel


def test_hidden_states_match_jax(tiny):
    cfg, tree, mel = tiny
    params = jax.tree.map(jnp.asarray, tree)
    enc_last, enc_ref = jw.whisper_encoder_forward(params, jnp.asarray(mel), _jax_cfg(cfg),
                                                   precision=HIGHEST)
    _, dec_ref = jw.whisper_decoder_step(params, enc_last, 0, _jax_cfg(cfg), precision=HIGHEST)
    _, enc, _, dec = _port(cfg, tree)(_t(mel))
    assert enc.shape == (cfg.encoder_layers + 1, 2, 1500, cfg.d_model)
    assert dec.shape == (cfg.decoder_layers + 1, 2, 1, cfg.d_model)
    for ours, ref in ((enc.numpy(), np.asarray(enc_ref)), (dec.numpy(), np.asarray(dec_ref))):
        assert ours.shape == ref.shape
        for i in range(ref.shape[0]):
            for b in range(2):
                assert cosine_distance(ours[i, b], ref[i, b]) <= FIDELITY_BAR
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("preset,bar", [("fidelity", FIDELITY_BAR), ("fast", FAST_BAR)])
def test_extractor_matches_jax_f32(tiny, preset, bar):
    cfg, tree, _ = tiny
    lengths = [32_000, 9_000, 480_000]
    waves = _clips(2, lengths)
    ref = JaxWhisperExtractor(_jax_cfg(cfg), jax.tree.map(jnp.asarray, tree),
                              preset="fidelity")(_batch(JaxBatch, waves, lengths))
    ex = WhisperExtractor(_port(cfg, tree), "cpu", preset=preset)
    ours = ex(_batch(Batch, waves, lengths))
    assert ex.column_names == ["encoder_layer_2", "encoder_layer_1", "encoder_layer_0",
                               "decoder_layer_2", "decoder_layer_1", "decoder_layer_0"]
    assert all(a.shape == (3, cfg.d_model) and a.dtype == np.float32 for a in ours.values())
    assert _max_pooled_distance(ours, ref, 3) <= bar


def test_128_mel_extractor_matches_jax():
    """large-v3's 128 mel bins through the frontend and the conv stem."""
    cfg = dataclasses.replace(tw.WhisperConfig.tiny(), num_mel_bins=128)
    tree = _tree(cfg, seed=8)
    lengths = [40_000, 480_000]
    waves = _clips(9, lengths)
    ref = JaxWhisperExtractor(_jax_cfg(cfg), jax.tree.map(jnp.asarray, tree),
                              preset="fidelity")(_batch(JaxBatch, waves, lengths))
    ours = WhisperExtractor(_port(cfg, tree), "cpu")(_batch(Batch, waves, lengths))
    assert _max_pooled_distance(ours, ref, 2) <= FIDELITY_BAR


@pytest.fixture(scope="module")
def large_two_layers():
    """Whisper-large widths with 2 encoder and 2 decoder layers, one 2 s clip:
    the JAX fidelity extractor's output (f32, HIGHEST) and the weights."""
    cfg = dataclasses.replace(tw.WhisperConfig.large(), encoder_layers=2, decoder_layers=2)
    tree = _tree(cfg, seed=3)
    lengths = [32_000]
    waves = _clips(4, lengths)
    ref = JaxWhisperExtractor(_jax_cfg(cfg), jax.tree.map(jnp.asarray, tree),
                              preset="fidelity")(_batch(JaxBatch, waves, lengths))
    return cfg, tree, waves, lengths, ref


@pytest.mark.parametrize("preset,bar", [("fidelity", FIDELITY_BAR), ("fast", FAST_BAR)])
def test_full_width_large_matches_jax_f32(large_two_layers, preset, bar):
    cfg, tree, waves, lengths, ref = large_two_layers
    ex = WhisperExtractor(_port(cfg, tree), "cpu", preset=preset)
    ours = ex(_batch(Batch, waves, lengths))
    assert all(np.isfinite(a).all() and a.shape == (1, 1280) for a in ours.values())
    worst = _max_pooled_distance(ours, ref, 1)
    print(f"{preset}: port vs JAX f32 pooled cosine distance, max {worst:.3e}")
    assert worst <= bar


def test_batched_equals_per_clip(tiny):
    cfg, tree, _ = tiny
    lengths = [480_000, 20_000, 3_000]
    waves = _clips(5, lengths)
    ex = WhisperExtractor(_port(cfg, tree), "cpu", preset="fidelity")
    batched = ex(_batch(Batch, waves, lengths))
    for b in range(3):
        alone = ex(_batch(Batch, waves[b:b + 1, :lengths[b]], lengths[b:b + 1]))
        for col, arr in alone.items():
            np.testing.assert_allclose(batched[col][b], arr[0], atol=1e-5, rtol=0)


def test_converter_uses_every_leaf():
    cfg = tw.WhisperConfig.tiny()
    tree = jax.tree.map(np.asarray, jw.init_whisper_params(jax.random.key(0), _jax_cfg(cfg)))
    state = whisper_params_from_numpy(tree, cfg)
    assert sum(t.numel() for t in state.values()) == sum(a.size for a in jax.tree.leaves(tree))
    assert set(state) == set(tw.WhisperModel(cfg, device="meta").state_dict())
    with pytest.raises(ValueError, match="stray"):
        whisper_params_from_numpy(dict(tree, stray=np.zeros(3, np.float32)), cfg)
    enc = dict(tree["encoder"], layers=dict(tree["encoder"]["layers"], stray=np.zeros((2, 3))))
    with pytest.raises(ValueError, match="stray"):
        whisper_params_from_numpy(dict(tree, encoder=enc), cfg)
    enc = {k: v for k, v in tree["encoder"].items() if k != "ln_s"}
    with pytest.raises(KeyError, match="encoder/ln_s"):
        whisper_params_from_numpy(dict(tree, encoder=enc), cfg)
    layers = {k: v for k, v in tree["decoder"]["layers"].items() if k != "xattn_k_w"}
    with pytest.raises(KeyError, match="xattn.k_w"):
        whisper_params_from_numpy(dict(tree, decoder=dict(tree["decoder"], layers=layers)), cfg)


def test_init_whisper_is_seeded():
    cfg = tw.WhisperConfig.tiny()
    a = init_whisper(cfg, torch.Generator().manual_seed(0)).state_dict()
    b = init_whisper(cfg, torch.Generator().manual_seed(0)).state_dict()
    c = init_whisper(cfg, torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layers.0.attn.q_w"], c["encoder.layers.0.attn.q_w"])
    assert torch.equal(a["decoder.layers.1.ln3_s"], torch.ones(cfg.d_model))
    assert torch.equal(a["encoder.layers.0.attn.v_b"], torch.zeros(cfg.d_model))
    np.testing.assert_array_equal(a["encoder.pos_embed"].numpy(), tw.sinusoids(1500, 32))
    ref = jax.tree.map(np.asarray, jw.init_whisper_params(jax.random.key(0), _jax_cfg(cfg)))
    for name, leaf, std in (("encoder.conv2_w", ref["encoder"]["conv2_w"], (32 * 3) ** -0.5),
                            ("decoder.embed_tokens", ref["decoder"]["embed_tokens"], 0.02)):
        assert a[name].shape == leaf.shape  # drawn like JAX: the same scale
        assert abs(float(a[name].std()) / std - 1) < 0.2 and abs(leaf.std() / std - 1) < 0.2


def test_cpu_wrappers_leave_launches_at_zero(tiny):
    cfg, tree, _ = tiny
    ex = WhisperExtractor(_port(cfg, tree), "cpu", preset="fast")
    ex(_batch(Batch, _clips(6, [8_000]), [8_000]))
    assert tmha.flash_mha.launches == 0
    with pytest.raises(ValueError, match="CUDA kernel"):
        tmha.flash_mha(*(torch.zeros(1, 2, 8, 64) for _ in range(3)))


@pytest.mark.parametrize("fault", ["head_dim", "dtype", "lengths", "strides", "bf16_alignment",
                                   "kv_valid_dtype", "kv_valid_shape"])
def test_kernel_input_checks(fault):
    B, H, L, d = 2, 3, 10, 64
    q, k, v = (torch.zeros(B, H, L, d) for _ in range(3))
    kv_valid = torch.full((B,), L, dtype=torch.int32)
    if fault == "head_dim":
        q, k, v = (torch.zeros(B, H, L, 32) for _ in range(3))
    elif fault == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif fault == "lengths":  # the kernel takes Lq == Lk
        k, v = torch.zeros(B, H, L + 1, d), torch.zeros(B, H, L + 1, d)
    elif fault == "bf16_alignment":  # rows of 8 bytes offset from a 16-byte boundary
        q, k, v = (torch.zeros(B, H, L * d + 4, dtype=torch.bfloat16)[..., 4:]
                   .view(B, H, L, d) for _ in range(3))
    elif fault == "kv_valid_dtype":
        kv_valid = kv_valid.long()
    elif fault == "kv_valid_shape":
        kv_valid = torch.full((B + 1,), L, dtype=torch.int32)
    else:
        k = torch.zeros(B, L, H, d).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        tmha._check(q, k, v, kv_valid)
    if fault == "strides":  # q, k, v in one [B, L, H, d] layout are taken
        q, v = (torch.zeros(B, L, H, d).transpose(1, 2) for _ in range(2))
        tmha._check(q, k, v, None)


def test_pipeline_honours_preferred_buckets(tiny):
    cfg, tree, _ = tiny
    pipe = ExtractionPipeline(WhisperExtractor(_port(cfg, tree), "cpu"))
    assert pipe.batcher.buckets_s == (30.0,) and pipe.batcher.frame_align is None
    assert pipe.batcher.bucket_samples(30.0) == 480_000
    wavlm = WavLMExtractor(init_wavlm(WavLMConfig.tiny(), torch.Generator().manual_seed(0)),
                           "cpu")
    assert ExtractionPipeline(wavlm).batcher.buckets_s == DEFAULT_BUCKETS_S


def test_store_matches_jax(tiny, tmp_path):
    """Default-constructed pipelines of both packages on one tiny corpus."""
    cfg, tree, _ = tiny
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 3, "test": 2, "devel": 2},
                          duration_range=(0.5, 2.5), seed=7)
    JaxPipeline(JaxWhisperExtractor(_jax_cfg(cfg), jax.tree.map(jnp.asarray, tree)),
                checkpoint_interval=2).run(jax_scan(root), str(tmp_path / "jax"))
    ex = WhisperExtractor(_port(cfg, tree), "cpu")
    ExtractionPipeline(ex, checkpoint_interval=2).run(create_metadata_from_files(root),
                                                      str(tmp_path / "port"))
    for split in ("train", "test", "devel"):
        jax_dir, port_dir = tmp_path / "jax" / split, tmp_path / "port" / split
        name = "embedding_metadata.csv"
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()
        assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
        for col in ex.column_names:
            ours = np.load(port_dir / f"{col}_embeddings.npy")
            ref = np.load(jax_dir / f"{col}_embeddings.npy")
            assert ours.shape == ref.shape == (len(ref), cfg.d_model)
            assert max(cosine_distance(a, b) for a, b in zip(ours, ref)) <= FIDELITY_BAR
    assert sorted(os.listdir(tmp_path / "port" / "checkpoints")) == \
        sorted(os.listdir(tmp_path / "jax" / "checkpoints"))


def test_cli_random_init_on_cpu(tmp_path):
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 2, "test": 1, "devel": 1},
                          duration_range=(0.3, 0.6), seed=1)
    out = str(tmp_path / "out")
    rc = cli.main(["--data_dir", root, "--output_dir", out, "--random_init",
                   "--model_name", "openai/whisper-tiny", "--device", "cpu",
                   "--preset", "fidelity", "--batch_size", "2"])
    assert rc == 0
    for split, n in (("train", 2), ("test", 1), ("devel", 1)):
        for col in ("encoder_layer_4", "encoder_layer_3", "encoder_layer_2",
                    "decoder_layer_4", "decoder_layer_3", "decoder_layer_2"):
            arr = np.load(os.path.join(out, split, f"{col}_embeddings.npy"))
            assert arr.shape == (n, 384) and np.isfinite(arr).all()


@pytest.mark.parametrize("extra", [[], ["--random_init", "--long_files", "chunk"],
                                   ["--random_init", "--preset", "turbo", "--long_files",
                                    "chunk"],
                                   ["--random_init", "--devices", "2", "--tp", "3"],
                                   ["--random_init", "--tp", "2"],
                                   ["--random_init", "--verify_model"]])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, caplog, extra):
    """Layouts of the multi-device flags that do not divide raise (--tp 2 on
    the one process of --device cpu, --tp 3 of 2). What used to raise now
    runs (--devices 2 in tests/test_torch_parallel.py): a hub
    name raises OSError naming a local checkpoint directory (no download),
    --long_files chunk writes the long rows (fidelity and turbo),
    --verify_model logs and runs."""
    out = str(tmp_path / "o")
    if "--devices" in extra or "--tp" in extra:
        with pytest.raises(ValueError, match="mesh"):
            cli.main(["--data_dir", str(tmp_path), "--output_dir", out, "--device", "cpu",
                      *extra])
        return
    if not extra:
        with pytest.raises(OSError, match="local checkpoint directory"):
            cli.main(["--data_dir", str(tmp_path), "--output_dir", out, "--device", "cpu"])
        return
    monkeypatch.setattr(tw.WhisperConfig, "tiny_official",
                        staticmethod(lambda: tw.WhisperConfig.tiny(d_model=32, layers=2, heads=4)))
    root = tmp_path / "corpus"
    make_synthetic_corpus(str(root), n_per_split={"train": 1}, duration_range=(0.3, 0.6), seed=2)
    x = (np.random.RandomState(5).randn(31 * 16000) * 0.1).astype(np.float32)
    from stutter_tpu_torch.audio.wavio import write_wav

    write_wav(str(root / "wav" / "train_long.wav"), x, 16000)  # 30 s + 1 s chunks
    preset = [] if "--preset" in extra else ["--preset", "fidelity"]
    with caplog.at_level("INFO"):
        rc = cli.main(["--data_dir", str(root), "--output_dir", out, *extra, *preset,
                       "--model_name", "openai/whisper-tiny", "--device", "cpu",
                       "--split", "train", "--batch_size", "2"])
    assert rc == 0
    with open(os.path.join(out, "train", "embedding_metadata.csv")) as f:
        lines = f.read().splitlines()
    arr = np.load(os.path.join(out, "train", "encoder_layer_2_embeddings.npy"))
    assert len(lines) == 3 and arr.shape == (2, 32) and np.isfinite(arr).all()
    if "chunk" in extra:  # the long row carries its chunk count; the other none
        assert lines[0].split(",")[-1] == "chunks"
        assert sorted(line.split(",")[-1] for line in lines[1:]) == ["", "2.0"]
    else:
        assert "chunks" not in lines[0]
        assert any("Whisper verified: 3 encoder / 3 decoder hidden states" in r.message
                   for r in caplog.records)


@pytest.mark.parametrize("entry", ["extract_whisper", "profile_whisper"])
def test_cuda_entry_points_raise_without_card(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "extract_whisper":
            cli.main(["--data_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"),
                      "--random_init"])
        else:
            profile_cli.main([])


def test_gemm_stem_matches_jax_and_the_conv_stem(tiny):
    """The stem as three shifted GEMMs (``gemm_stem``) against JAX's
    ``gemm_stem`` forward and the port's conv stem: every encoder state
    within FIDELITY_BAR cosine distance, the stem's output within 1e-5."""
    cfg, tree, mel = tiny
    params = jax.tree.map(jnp.asarray, tree)
    _, ref = jw.whisper_encoder_forward(params, jnp.asarray(mel), _jax_cfg(cfg),
                                        precision=HIGHEST, gemm_stem=True)
    model = _port(cfg, tree)
    with torch.inference_mode():
        _, states = model.encoder(_t(mel), gemm_stem=True)
        _, conv_states = model.encoder(_t(mel))
        gemm, conv = model.encoder.stem(_t(mel), gemm_stem=True), model.encoder.stem(_t(mel))
    assert gemm.shape == conv.shape == (2, 1500, cfg.d_model)
    np.testing.assert_allclose(gemm.numpy(), conv.numpy(), atol=1e-5, rtol=0)
    ref = np.asarray(ref)
    for i in range(ref.shape[0]):
        for b in range(2):
            assert cosine_distance(states[i][b].numpy(), ref[i, b]) <= FIDELITY_BAR
            assert cosine_distance(states[i][b].numpy(), conv_states[i][b].numpy()) <= FIDELITY_BAR
    np.testing.assert_allclose(torch.stack(states).numpy(), ref, atol=1e-5, rtol=0)
