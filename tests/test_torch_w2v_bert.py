"""w2v-BERT 2.0 in the port, on the CPU, against the benchmark's plain
reference (``benchmark/reference/w2v_bert.py``) and HF's
``transformers.Wav2Vec2BertModel`` and ``SeamlessM4TFeatureExtractor``.

The JAX package has no w2v-BERT, so the references are those. Bars:
- every hidden state against the reference, f32, seeded random weights, on
  the reference's own features: ``F32_STATE_TOL`` of the state's scale;
- the frontend (f32 on the device) against HF's and the reference's float64
  fbank: ``FBANK_MAX_ABS`` on the normalised values (~unit scale);
- the extractor's pooled rows (fidelity; fast, the whole model in bf16)
  against the f32 reference from the wave: ``FIDELITY_POOLED_COS`` and
  ``BF16_POOLED_COS`` cosine distance; turbo's int8 products fail the fast
  bar, as the benchmark's limit fails its control;
- a padded batch against each clip alone, f32: ``F32_STATE_TOL`` on the
  valid rows (padding must not leak through the keys or the depthwise conv);
- the port against HF through ``load_w2v_bert``: ``HF_MAX_ABS`` on every
  hidden state;
- the relative-key attention's plain version against HF's einsum form:
  ``F32_ATTN_TOL``.
"""

import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from benchmark.reference import w2v_bert as reference
from benchmark.weights import seeded_weights
from stutter_tpu_torch.audio.synthetic import make_synthetic_corpus
from stutter_tpu_torch.extract.batcher import Batch
from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, W2VBertExtractor
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.frontend.w2v_bert_frontend import (
    fbank_frames,
    w2v_bert_features,
    w2v_bert_frame_lengths,
)
from stutter_tpu_torch.models.w2v_bert import W2VBertConfig, W2VBertModel
from stutter_tpu_torch.ops import relkey_attention as rk
from stutter_tpu_torch.ops.mel import kaldi_mel_filter_bank
from stutter_tpu_torch.weights import convert
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

F32_STATE_TOL = 1e-4
F32_ATTN_TOL = 1e-5
FBANK_MAX_ABS = 5e-4  # HF keeps the spectrum in complex64: its low bins differ by ~2.4e-4
HF_MAX_ABS = 2e-5
# fidelity reads ~7e-8 here (the f32 fbank against the reference's float64
# one), fast ~1.7e-5 and turbo ~8.3e-5
FIDELITY_POOLED_COS = 1e-6
BF16_POOLED_COS = 3e-5
# samples: 98 fbank frames (49 rows), 105 (odd: 52 rows) and 120 (60 rows)
LENGTHS = (16000, 17153, 19500)


def _as_dict(cfg: W2VBertConfig) -> dict:
    """The benchmark configuration file's form of ``cfg``."""
    return dataclasses.asdict(cfg)


def _model(cfg=None, seed=7):
    """(f32 model, its f32 weights) filled by the benchmark's seeded draw."""
    cfg = cfg or W2VBertConfig.tiny()
    model = W2VBertModel(cfg)
    weights = {k: v.float() for k, v in seeded_weights(model, seed).items()}
    model.load_state_dict(weights)
    return model, weights


def _waves(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.3 * np.sin(np.arange(n) / 16000 * 2 * np.pi * rng.uniform(100, 600))
             + 0.05 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


def _padded(waves):
    batch = torch.zeros(len(waves), max(map(len, waves)))
    for i, w in enumerate(waves):
        batch[i, :len(w)] = torch.from_numpy(w)
    return batch, torch.tensor([len(w) for w in waves])


def test_preset_carries_the_published_widths():
    cfg = W2VBertConfig.w2v_bert_2_0()
    assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_attention_heads, cfg.head_dim) == (24, 1024, 4096, 16, 64)
    assert (cfg.feature_projection_input_dim, cfg.conv_depthwise_kernel_size,
            cfg.left_max_position_embeddings, cfg.right_max_position_embeddings) == (
        160, 31, 64, 8)
    model = W2VBertModel(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == pytest.approx(0.58e9, rel=0.01)


@pytest.mark.parametrize("change,match", [
    ({"position_embeddings_type": "relative"}, "not ported"),
    ({"position_embeddings_type": "rotary"}, "not ported"),
    ({"add_adapter": True}, "adapter"),
    ({"use_intermediate_ffn_before_adapter": True}, "adapter"),
    ({"hidden_act": "gelu"}, "swish"),
    ({"left_max_position_embeddings": 32}, "clamped"),
    ({"feature_projection_input_dim": 80}, "stride"),
])
def test_config_refuses_what_is_not_ported(change, match):
    with pytest.raises(ValueError, match=match):
        W2VBertConfig(**change)


@pytest.mark.parametrize("L,kv", [
    (37, None), (160, (160, 101, 1)), (200, None), (257, (257, 64, 130))])
def test_relkey_reference_matches_the_einsum_definition(L, kv):
    """The plain version (T = q E^T gathered at the clamped distances)
    against HF's einsum of q with the [L, L, d] embeddings, across both
    clamps and the band, with keys masked and L off the 64-row tiles."""
    g = torch.Generator().manual_seed(L)
    B, H, d = 3, 2, 16
    q, k, v = (torch.randn(B, H, L, d, generator=g) for _ in range(3))
    emb = torch.randn(rk.TERMS, d, generator=g)
    kv_valid = None if kv is None else torch.tensor(kv, dtype=torch.int32)
    got = rk.relkey_attention_reference(q, k, v, emb, kv_valid)
    pos = torch.arange(L)
    distance = (pos[None, :] - pos[:, None]).clamp(-rk.LEFT, rk.RIGHT) + rk.LEFT
    s = q @ k.transpose(-1, -2) + torch.einsum("bhld,lrd->bhlr", q, emb[distance])
    if kv_valid is not None:
        s = s + torch.where(pos[None, :] < kv_valid[:, None].long(), 0.0, -1e9)[:, None, None]
    want = torch.softmax(s, dim=-1) @ v
    assert float((got - want).abs().max()) <= F32_ATTN_TOL
    assert torch.equal(rk.relkey_self_attention(q, k, v, emb, kv_valid), got)


@pytest.mark.parametrize("L", [1, 63, 64, 150])
def test_relative_terms_clamp_to_the_table(L):
    terms = rk.relative_terms(L)
    i, j = torch.meshgrid(torch.arange(L), torch.arange(L), indexing="ij")
    assert torch.equal(terms, (j - i).clamp(-64, 8) + 64)
    assert int(terms.min()) >= 0 and int(terms.max()) <= rk.TERMS - 1


@pytest.mark.parametrize("bad", ["cpu", "emb"])
def test_kernel_wrapper_refuses_what_it_cannot_launch(bad):
    q = k = v = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA" if bad == "cpu" else "distance embeddings"):
        if bad == "cpu":
            rk.relkey_attention(q, k, v, torch.zeros(rk.TERMS, 64))
        else:
            rk.relkey_attention_reference(q, k, v, torch.zeros(rk.TERMS - 1, 64))


def test_kaldi_mel_bank_matches_hf():
    audio_utils = pytest.importorskip("transformers.audio_utils")
    want = audio_utils.mel_filter_bank(
        num_frequency_bins=257, num_mel_filters=80, min_frequency=20, max_frequency=8000,
        sampling_rate=16000, norm=None, mel_scale="kaldi", triangularize_in_mel_space=True)
    got = kaldi_mel_filter_bank(257, 80, 20.0, 8000, 16000, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("lengths", [(16000,), (17153,), (19500, 16000, 17153)])
def test_frontend_matches_seamless_feature_extractor(lengths):
    """Clips with odd (17153: 105 frames) and even fbank frame counts, alone
    and padded into one batch: the stacked rows, their count (HF's
    attention mask) and the zeroed padding."""
    transformers = pytest.importorskip("transformers")
    fe = transformers.SeamlessM4TFeatureExtractor()
    waves = _waves(lengths)
    out = fe(waves, sampling_rate=16000, return_tensors="np", padding=True)
    batch, lens = _padded(waves)
    feats, rows = w2v_bert_features(batch, lens)
    assert rows.tolist() == out["attention_mask"].sum(1).tolist()
    assert rows.tolist() == [w2v_bert_frame_lengths(n) for n in lengths]
    assert [fbank_frames(n) for n in lengths] == [1 + (n - 400) // 160 for n in lengths]
    for i, n in enumerate(rows.tolist()):
        want = out["input_features"][i, :n]
        assert float(np.abs(feats[i, :n].numpy() - want).max()) <= FBANK_MAX_ABS
        pad = feats[i, n:].clone()
        if fbank_frames(lengths[i]) % 2 and len(pad):
            pad[0, :80] = 0  # an odd last frame sits in the first masked row
        assert not pad.any()
        np.testing.assert_allclose(reference.features(waves[i]), want, rtol=0,
                                   atol=FBANK_MAX_ABS)


def test_every_hidden_state_matches_the_reference():
    cfg = W2VBertConfig.tiny()
    model, weights = _model(cfg)
    for wave in _waves():
        feats = torch.from_numpy(reference.features(wave))
        want = reference.hidden_states(_as_dict(cfg), weights, feats)
        _, states, frames = model(feats[None])
        assert states.shape[0] == cfg.num_hidden_layers + 1 == len(want)
        for j, w in enumerate(want):
            err = float((states[j, 0] - w).abs().max())
            assert err <= F32_STATE_TOL * max(1.0, float(w.abs().max())), (j, err)


def test_padded_batch_equals_each_clip_alone():
    model, _ = _model()
    waves = _waves()
    batch, lens = _padded(waves)
    feats, rows = w2v_bert_features(batch, lens)
    _, states, frames = model(feats, rows)
    assert frames.tolist() == rows.tolist()
    for i, wave in enumerate(waves):
        alone, one = _padded([wave])
        f1, r1 = w2v_bert_features(alone, one)
        _, single, _ = model(f1, r1)
        n = int(rows[i])
        assert int(r1[0]) == n
        err = float((states[:, i, :n] - single[:, 0, :n]).abs().max())
        assert err <= F32_STATE_TOL, (i, err)


def test_fold_is_bit_equal_on_bf16_weights():
    """The 1/2 folded into w2 and b2 and head_dim^-1/2 (1/4 at the tiny 16,
    1/8 at 64) into q's weight and bias at load: powers of two, so folding
    then casting to bf16 gives the bits of casting then folding, the state
    dict gives back the published values bit for bit, and loading it again
    folds nothing twice."""
    model, weights = _model()
    folds = model.folds()
    assert folds["layers.0.ffn1.w2"] == folds["layers.1.ffn2.b2"] == 0.5
    assert folds["layers.0.attention.q_b"] == 0.25 and len(folds) == 12
    params = dict(model.named_parameters())
    for name, factor in folds.items():
        assert torch.equal(params[name], weights[name] * factor), name
    cast = model.to(torch.bfloat16)
    params = dict(cast.named_parameters())
    for name, factor in folds.items():
        assert torch.equal(params[name], weights[name].to(torch.bfloat16) * factor), name
    saved = cast.state_dict()
    assert all(torch.equal(saved[k], v.to(torch.bfloat16)) for k, v in weights.items())
    again = W2VBertModel(W2VBertConfig.tiny(), dtype=torch.bfloat16)
    again.load_state_dict(saved)
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), cast.parameters()))
    batch, lens = _padded(_waves())
    feats, rows = w2v_bert_features(batch, lens)
    _, want, _ = cast(feats.to(torch.bfloat16), rows)
    _, got, _ = again(feats.to(torch.bfloat16), rows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("preset,bar", [("fidelity", FIDELITY_POOLED_COS),
                                        ("fast", BF16_POOLED_COS)])
def test_pooled_rows_match_the_reference(preset, bar):
    """The extractor's rows (fidelity: f32; fast: the whole model in bf16,
    int16 wave transfer) against the f32 reference's pooled states."""
    from benchmark.families import w2v_bert as family

    cfg = W2VBertConfig.tiny()
    model, weights = _model(cfg)
    ex = W2VBertExtractor(model, "cpu", preset=preset)
    assert ex.layer_indices == (2, 1, 0, 1)  # N - 1, N - 2, N - 3 and N // 2 of the N + 1
    waves = _waves()
    batch, lens = _padded(waves)
    got = ex(Batch(paths=["a", "b", "c"], rows=[0, 1, 2], waves=batch.numpy(),
                   lengths=lens.numpy(), ok=np.ones(3, bool), bucket_s=batch.shape[1] / 16000))
    want = family.reference_rows(_as_dict(cfg), weights, waves, "cpu")
    assert set(got) == set(want[0]) == set(ex.column_names)
    for j, row in enumerate(want):
        for col, r in row.items():
            assert cosine_distance(got[col][j], r) <= bar, (preset, j, col)


def test_turbo_fails_the_fast_bar():
    """Turbo (int8 in every product of the layers, the conv module's too) is
    the benchmark's control: its rows must not pass the fast preset's bar."""
    from benchmark.families import w2v_bert as family

    cfg = W2VBertConfig.tiny()
    model, weights = _model(cfg)
    ex = W2VBertExtractor(model, "cpu", preset="turbo")
    layer = ex.model.layers[0]
    from stutter_tpu_torch.ops.quant import QuantizedWeight
    assert all(isinstance(w, QuantizedWeight) for w in (
        layer.attention.q_w, layer.ffn1.w1, layer.ffn2.w2, layer.conv.pw1_w, layer.conv.pw2_w))
    waves = _waves()
    batch, lens = _padded(waves)
    got = ex(Batch(paths=["a", "b", "c"], rows=[0, 1, 2], waves=batch.numpy(),
                   lengths=lens.numpy(), ok=np.ones(3, bool), bucket_s=batch.shape[1] / 16000))
    want = family.reference_rows(_as_dict(cfg), weights, waves, "cpu")
    worst = max(cosine_distance(got[c][j], r) for j, row in enumerate(want)
                for c, r in row.items())
    assert worst > BF16_POOLED_COS


HF_TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, layerdrop=0.0, mask_time_prob=0.05)


def _hf(kwargs=HF_TINY, cls_name="Wav2Vec2BertModel"):
    """A random HF model whose every parameter is moved off its init (norm
    scales of 1 and zero biases would hide a swapped or missing one)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = getattr(transformers, cls_name)(transformers.Wav2Vec2BertConfig(**kwargs)).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def _save(model, path):
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    model.config.to_json_file(os.path.join(path, "config.json"))
    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({"feature_size": 80, "num_mel_bins": 80, "stride": 2,
                   "sampling_rate": 16000}, f)
    return path


def _check_against_hf(tmp_path, groups):
    """Every hidden state of the port (through the converter) against HF's
    (through HF's frontend) on each group of clips padded into one batch,
    on each clip's rows."""
    transformers = pytest.importorskip("transformers")
    hf = _hf()
    cfg, model = convert.load_w2v_bert(_save(hf, str(tmp_path / "ckpt")))
    assert cfg.hidden_size == 64 and cfg.stride == 2
    fe = transformers.SeamlessM4TFeatureExtractor()
    for group in groups:
        out = fe(group, sampling_rate=16000, return_tensors="pt", padding=True)
        mask = out["attention_mask"]
        with torch.no_grad():
            want = hf(out["input_features"], attention_mask=mask,
                      output_hidden_states=True).hidden_states
        _, got, _ = model(out["input_features"], mask.sum(1))
        assert got.shape[0] == len(want) == cfg.num_hidden_layers + 1
        for i, n in enumerate(mask.sum(1).tolist()):
            for j, w in enumerate(want):
                err = float((got[j, i, :n] - w[i, :n]).abs().max())
                assert err <= HF_MAX_ABS * max(1.0, float(w[i, :n].abs().max())), (i, j, err)
    return mask.sum(1).tolist()


@pytest.mark.parametrize("batched", [False, True])
def test_forward_matches_hf(tmp_path, batched):
    """The layer equations against HF's, through the converter and HF's
    frontend: each clip alone, and a padded batch with HF's attention mask
    against the port's rows, every hidden state on each clip's rows."""
    waves = _waves()
    _check_against_hf(tmp_path, [waves] if batched else [[w] for w in waves])


def test_forward_matches_hf_past_both_clamps(tmp_path):
    """A clip of 152 rows beside one of 49: distances reach both clamps
    (-64 and +8) of the converted distance embeddings, so every row of the
    table enters the scores, with the short clip's keys masked."""
    rows = _check_against_hf(tmp_path, [_waves((49000, 16000))])
    assert rows == [152, 49] and rows[0] > rk.LEFT + rk.RIGHT + 1


@pytest.mark.parametrize("cls_name,prefixed", [("Wav2Vec2BertModel", False),
                                               ("Wav2Vec2BertForCTC", True)])
def test_converter_takes_every_backbone_key(cls_name, prefixed):
    kwargs = dict(HF_TINY, vocab_size=32) if prefixed else HF_TINY
    hf = _hf(kwargs, cls_name)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    assert any(k.startswith("wav2vec2_bert.") for k in sd) == prefixed
    cfg = convert.w2v_bert_config_from_hf(hf.config.to_dict())
    state = convert.convert_w2v_bert_state_dict(sd, cfg)
    assert set(state) == set(W2VBertModel(cfg, device="meta").state_dict())
    assert tuple(state["layers.0.conv.pw1_w"].shape) == (128, 64)
    extra = dict(sd, **{"encoder.layers.0.extra": np.zeros(1, np.float32)})
    if not prefixed:
        with pytest.raises(ValueError, match="extra"):
            convert.convert_w2v_bert_state_dict(extra, cfg)


@pytest.mark.parametrize("key,value", [("position_embeddings_type", "rotary"),
                                       ("add_adapter", True), ("hidden_act", "gelu")])
def test_config_from_hf_refuses_what_is_not_ported(key, value):
    with pytest.raises(ValueError):
        convert.w2v_bert_config_from_hf({**HF_TINY, key: value})


def test_extractor_refuses_heads_the_kernel_lacks():
    with pytest.raises(ValueError, match="heads of 16"):
        W2VBertExtractor.check_device(W2VBertConfig.tiny(), "cuda")
    W2VBertExtractor.check_device(W2VBertConfig.tiny(), "cpu")
    W2VBertExtractor.check_device(W2VBertConfig.w2v_bert_2_0(), "cuda")


def test_pipeline_stores_every_clip(tmp_path):
    """ExtractionPipeline drives the extractor over a tiny corpus into the
    store; each stored row equals the clip run alone."""
    cfg = W2VBertConfig.tiny()
    model, _ = _model(cfg)
    ex = W2VBertExtractor(model, "cpu", preset="fidelity")
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 3, "test": 1, "devel": 1},
                          duration_range=(1.0, 1.6), seed=2)
    from stutter_tpu_torch.extract.batcher import BucketBatcher

    pipe = ExtractionPipeline(ex, batcher=BucketBatcher(audio_budget_s=4.0, max_batch=4,
                                                        frame_align=ex.frame_align))
    meta = create_metadata_from_files(root, split="train")
    rows = pipe.run_split(meta, "train", str(tmp_path / "out"))
    assert len(rows) == 3
    stored = np.load(tmp_path / "out" / "train" / "layer_2_embeddings.npy")
    assert stored.shape == (3, cfg.hidden_size) and np.isfinite(stored).all()


@pytest.fixture
def fresh_logging(monkeypatch):
    """The package's logging unset for this test and restored after it."""
    from stutter_tpu_torch.utils import logging as tlog

    logger = logging.getLogger("stutter_tpu_torch")
    monkeypatch.setattr(tlog, "_configured", False)
    monkeypatch.setattr(tlog, "_logfile", None)
    monkeypatch.setattr(logger, "handlers", [])
    monkeypatch.setattr(logger, "level", logger.level)
    yield
    for h in logger.handlers:
        h.close()


def test_cli_extracts_a_tiny_checkpoint_on_cpu(tmp_path, monkeypatch, fresh_logging):
    from stutter_tpu_torch.cli import extract_w2v_bert as cli

    monkeypatch.chdir(tmp_path)  # the CLI's logfile goes under logs/ here
    ckpt = _save(_hf(), str(tmp_path / "ckpt"))
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 2, "test": 1, "devel": 1},
                          duration_range=(0.6, 1.0), seed=1)
    out = str(tmp_path / "out")
    rc = cli.main(["--data_dir", root, "--output_dir", out, "--model_path", ckpt,
                   "--device", "cpu", "--preset", "fidelity", "--audio_budget", "2",
                   "--batch_size", "2"])
    assert rc == 0
    assert list((tmp_path / "logs").glob("w2v_bert_embedding_*.log"))
    for split, n in (("train", 2), ("test", 1), ("devel", 1)):
        for layer in (2, 1, 0):
            arr = np.load(os.path.join(out, split, f"layer_{layer}_embeddings.npy"))
            assert arr.shape == (n, 64) and np.isfinite(arr).all()
    with pytest.raises(SystemExit, match="one device"):
        cli.main(["--data_dir", root, "--output_dir", out, "--model_path", ckpt,
                  "--device", "cpu", "--devices", "2"])
