"""wav2vec 2.0 (XLS-R) in the port, on the CPU, against the benchmark's plain
float32 reference (``benchmark/reference/wav2vec2.py``) and HF's
``transformers.Wav2Vec2Model``.

The JAX package has no wav2vec2, so the references are those two. Bars:
- every hidden state against the reference, f32, seeded random weights:
  ``F32_STATE_TOL`` of the state's scale (the same arithmetic; sums and the
  layer norms' statistics taken in another order);
- the fast preset's pooled rows (the whole model in bf16) against the f32
  reference: ``BF16_POOLED_COS`` cosine distance. The fast rows read ~4e-6
  here (bf16 rounds each layer's activations to ~4e-3 relative; a mean over
  frames averages most of it out); turbo's int8 projections read ~5e-5, so
  the bar fails the next precision down, as the benchmark's limit does;
- a padded batch against each clip alone, f32: ``F32_STATE_TOL`` on the valid
  frames (padding must not leak through the positional conv or the keys);
- the port against HF on an HF checkpoint through ``load_wav2vec2``:
  ``HF_MAX_ABS`` on every hidden state (the test of ``test_torch_checkpoint``
  for WavLM).
"""

import csv
import dataclasses
import json
import logging
import os

import numpy as np
import pytest
import torch

from benchmark.reference import wav2vec2 as reference
from benchmark.weights import seeded_weights
from stutter_tpu_torch.audio.synthetic import make_synthetic_corpus
from stutter_tpu_torch.extract.batcher import Batch, BucketBatcher
from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, Wav2Vec2Extractor
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
from stutter_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from stutter_tpu_torch.ops import _attention
from stutter_tpu_torch.ops import flash_mha as tmha
from stutter_tpu_torch.ops import wavlm_attention as tattn
from stutter_tpu_torch.weights import convert
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

F32_STATE_TOL = 1e-4
BF16_POOLED_COS = 2e-5
HF_MAX_ABS = 1e-5
LENGTHS = (4000, 5200, 3100)  # samples: 199, 259 and 154 frames of the 20x tiny stem


def _as_dict(cfg: Wav2Vec2Config) -> dict:
    """The benchmark configuration file's form of ``cfg``."""
    return {f.name: list(v) if isinstance(v := getattr(cfg, f.name), tuple) else v
            for f in dataclasses.fields(cfg)}


def _model(cfg=None, seed=7):
    """(f32 model, its f32 weights) filled by the benchmark's seeded draw."""
    cfg = cfg or Wav2Vec2Config.tiny()
    model = Wav2Vec2Model(cfg)
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


def test_presets_carry_the_published_widths():
    for cfg, layers, hidden, ffn, head_dim in (
            (Wav2Vec2Config.xls_r_2b(), 48, 1920, 7680, 120),
            (Wav2Vec2Config.xls_r_1b(), 48, 1280, 5120, 80),
            (Wav2Vec2Config.xls_r_300m(), 24, 1024, 4096, 64)):
        assert (cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size,
                cfg.num_attention_heads, cfg.head_dim) == (layers, hidden, ffn, 16, head_dim)
        assert cfg.stem_geometry == (400, 320) and cfg.conv_bias
    model = Wav2Vec2Model(Wav2Vec2Config.xls_r_2b(), device="meta")
    assert sum(p.numel() for p in model.parameters()) == pytest.approx(2.16e9, rel=0.01)


def test_every_hidden_state_matches_the_reference():
    cfg = Wav2Vec2Config.tiny()
    model, weights = _model(cfg)
    waves = _waves()
    batch, lens = _padded(waves)
    _, states, frames = model(wavlm_prepare_batch(batch, lens, cfg.do_normalize), lens)
    assert states.shape[0] == cfg.num_hidden_layers + 1
    for i, wave in enumerate(waves):
        want = reference.hidden_states(_as_dict(cfg), weights, torch.from_numpy(wave))
        n = int(frames[i])
        assert n == want[0].shape[0]
        for j, w in enumerate(want):
            err = float((states[j, i, :n] - w).abs().max())
            assert err <= F32_STATE_TOL * max(1.0, float(w.abs().max())), (i, j, err)


def test_padded_batch_equals_each_clip_alone():
    model, _ = _model()
    waves = _waves()
    batch, lens = _padded(waves)
    _, states, frames = model(wavlm_prepare_batch(batch, lens, True), lens)
    for i, wave in enumerate(waves):
        alone, one = _padded([wave])
        _, single, _ = model(wavlm_prepare_batch(alone, one, True), one)
        n = int(frames[i])
        assert single.shape[2] == n
        err = float((states[:, i, :n] - single[:, 0]).abs().max())
        assert err <= F32_STATE_TOL, (i, err)


@pytest.mark.parametrize("preset,bar", [("fidelity", 1e-10), ("fast", BF16_POOLED_COS)])
def test_pooled_rows_match_the_reference(preset, bar):
    """The extractor's rows (fidelity: f32; fast: the whole model in bf16,
    int16 wave transfer) against the f32 reference's pooled states."""
    from benchmark.families import wav2vec2 as family

    cfg = Wav2Vec2Config.tiny()
    model, weights = _model(cfg)
    ex = Wav2Vec2Extractor(model, "cpu", preset=preset)
    assert ex.layer_indices == (2, 1, 0, 1)  # N - 1, N - 2, N - 3 and N // 2 of the N + 1
    waves = _waves()
    batch, lens = _padded(waves)
    got = ex(Batch(paths=["a", "b", "c"], rows=[0, 1, 2], waves=batch.numpy(),
                   lengths=lens.numpy(), ok=np.ones(3, bool), bucket_s=batch.shape[1] / 16000))
    want = family.reference_rows(_as_dict(cfg), weights, waves, "cpu")
    assert set(got) == set(want[0]) == set(ex.column_names)
    for j, row in enumerate(want):
        for col, r in row.items():
            assert cosine_distance(got[col][j], r) < bar, (preset, j, col)


def test_turbo_quantizes_the_projections():
    from stutter_tpu_torch.ops.quant import QuantizedWeight

    model, _ = _model()
    ex = Wav2Vec2Extractor(model, "cpu", preset="turbo")
    layer = ex.model.layers[0]
    for module, name in ((layer.attention, "q_w"), (layer.attention, "o_w"),
                         (layer.feed_forward, "w1"), (layer.feed_forward, "w2")):
        assert isinstance(getattr(module, name), QuantizedWeight)
    assert ex.model.feature_projection.weight.dtype == torch.bfloat16


def test_extractor_runs_through_the_pipeline_into_the_store(tmp_path):
    """``ExtractionPipeline.run_split`` as ``WavLMExtractor`` is driven: the
    store's rows and columns, the checkpoints, and each row against the
    extractor called on that clip alone."""
    from stutter_tpu_torch.audio.wavio import load_audio

    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 5}, duration_range=(0.2, 0.6), seed=3)
    model, _ = _model()
    ex = Wav2Vec2Extractor(model, "cpu", preset="fidelity")
    batcher = BucketBatcher(buckets_s=(0.4, 0.8), audio_budget_s=1.6, max_batch=4,
                            frame_align=ex.frame_align)
    pipe = ExtractionPipeline(ex, batcher=batcher, checkpoint_interval=2)
    meta = create_metadata_from_files(root, split="train")
    rows = pipe.run_split(meta, "train", str(tmp_path / "out"))
    assert len(rows) == 5
    folder = tmp_path / "out" / "train"
    with open(folder / "embedding_metadata.csv", newline="") as f:
        paths = [r["path"] for r in csv.DictReader(f)]
    for col in ex.column_names:
        arr = np.load(folder / f"{col}_embeddings.npy")
        assert arr.shape == (5, 32) and np.isfinite(arr).all()
    assert list((tmp_path / "out" / "checkpoints").glob("checkpoint_train_*.pkl"))
    layer = np.load(folder / f"{ex.column_names[0]}_embeddings.npy")
    for i, path in enumerate(paths):
        wave = load_audio(path, 16000)
        alone = ex(Batch(paths=[path], rows=[0], waves=wave[None], lengths=np.array([len(wave)]),
                         ok=np.ones(1, bool), bucket_s=len(wave) / 16000))
        assert cosine_distance(layer[i], alone[ex.column_names[0]][0]) < 1e-10


def test_encode_span_names_the_family_and_head_dim():
    from stutter_tpu_torch.utils import profiling

    model, _ = _model()
    ex = Wav2Vec2Extractor(model, "cpu", preset="fidelity")
    waves = _waves((4000,))
    batch, lens = _padded(waves)
    profiling.reset()
    profiling.enable()
    try:
        ex(Batch(paths=["a"], rows=[0], waves=batch.numpy(), lengths=lens.numpy(),
                 ok=np.ones(1, bool), bucket_s=0.25))
    finally:
        profiling.disable()
    spans = [r for r in profiling.records() if r.name == "extract.encode"]
    profiling.reset()
    assert len(spans) == 1 and spans[0].attrs == {"family": "wav2vec2", "head_dim": 8}


def test_multi_rank_plan_raises():
    from stutter_tpu_torch.parallel.mesh import MeshPlan

    model, _ = _model()
    plan = MeshPlan(rank=0, world_size=2, data_size=2, model_size=1)
    with pytest.raises(NotImplementedError, match="one device"):
        Wav2Vec2Extractor(model, "cpu", preset="fidelity", plan=plan)


# ---------------------------------------------------------------------------
# The attention kernels' head_dim checks
# ---------------------------------------------------------------------------


def _qkv(d, dtype=torch.bfloat16, L=65):
    return tuple(torch.zeros(2, L, 3, d, dtype=dtype).transpose(1, 2) for _ in range(3))


@pytest.mark.parametrize("d", [64, 120])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_tiles_take_head_dim_64_and_120(d, dtype):
    expect = tmha.BF16_TILES if dtype == torch.bfloat16 else tmha.F32_TILES
    assert tmha.device_path(*_qkv(d, dtype)) == expect


@pytest.mark.parametrize("d", [32, 80, 96, 128])
def test_flash_tiles_refuse_other_head_dims(d):
    with pytest.raises(ValueError, match="head_dim 64 or 120"):
        _attention.check_qkv(*_qkv(d))


def test_bias_and_gated_kernels_keep_head_dim_64():
    q, k, v = _qkv(120)
    with pytest.raises(ValueError, match="head_dim 64, got 120"):
        tattn.device_path(q, k, v)
    with pytest.raises(ValueError, match="head_dim 64, got 120"):
        _attention.device_path(q, k, v, (_attention.HEAD_DIM,))
    assert tattn.device_path(*_qkv(64)) == tattn.BF16_TILES


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, for the wrappers' Python."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_flash_launches_are_counted_by_head_dim(monkeypatch):
    """Presented as the card's, the wrapper passes the head dim to the C
    entry and counts the launch under it."""
    import contextlib
    import types

    from stutter_tpu_torch.ops import _build

    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "kernel_library", lambda: types.SimpleNamespace(flash_mha=entry))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(tmha.flash_mha, "launches", 0)
    monkeypatch.setattr(tmha.flash_mha, "launches_by_head_dim",
                        type(tmha.flash_mha.launches_by_head_dim)())
    for d in (120, 64, 120):
        tmha.flash_mha(*(t.as_subclass(_OnCard) for t in _qkv(d)))
    assert [c[5:9] for c in calls] == [(2, 3, 65, 120), (2, 3, 65, 64), (2, 3, 65, 120)]
    assert all(len(c) == len(_build.SIGNATURES["flash_mha"][0]) for c in calls)
    assert tmha.flash_mha.launches == 3
    assert dict(tmha.flash_mha.launches_by_head_dim) == {120: 2, 64: 1}


# ---------------------------------------------------------------------------
# HF checkpoints and the CLI
# ---------------------------------------------------------------------------

HF_TINY = dict(  # XLS-R's layout at a tiny size: layer-norm stem with bias, stable pre-LN
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
    conv_dim=[16, 16, 16], conv_stride=[5, 2, 2], conv_kernel=[10, 3, 3],
    num_feat_extract_layers=3, conv_bias=True, feat_extract_norm="layer",
    do_stable_layer_norm=True, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    layerdrop=0.0, vocab_size=32, mask_time_prob=0.05)


def _hf(kwargs, cls_name="Wav2Vec2Model"):
    """A random HF model whose every parameter is moved off its init (norm
    scales of 1 and zero biases would hide a swapped or missing one)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    model = getattr(transformers, cls_name)(transformers.Wav2Vec2Config(**kwargs)).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


def _save(model, path, preprocessor=None):
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    model.config.to_json_file(os.path.join(path, "config.json"))
    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              os.path.join(path, "model.safetensors"))
    if preprocessor is not None:
        with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
            json.dump(preprocessor, f)
    return path


def test_forward_matches_hf(tmp_path):
    """The layer equations against HF's, through the converter: each clip
    alone and a padded batch with HF's attention mask against the port's
    sample lengths, every hidden state on each clip's frames."""
    hf = _hf(HF_TINY)
    cfg, model = convert.load_wav2vec2(_save(hf, str(tmp_path / "ckpt"),
                                             {"do_normalize": True}))
    assert cfg.do_normalize
    waves = _waves()
    cases = [_padded([w]) for w in waves] + [_padded(waves)]
    for batch, lens in cases:
        mask = (torch.arange(batch.shape[1])[None] < lens[:, None]).long()
        with torch.no_grad():
            golden = hf(batch, attention_mask=mask, output_hidden_states=True).hidden_states
        _, ours, frames = model(batch, lens)
        assert ours.shape[0] == len(golden) == cfg.num_hidden_layers + 1
        for i, g in enumerate(golden):
            for b in range(len(lens)):
                n = int(frames[b])
                err = float((ours[i, b, :n] - g[b, :n]).abs().max())
                assert err <= HF_MAX_ABS * max(1.0, float(g[b, :n].abs().max())), (i, b, err)


def test_pretraining_checkpoint_drops_its_quantizer(tmp_path, caplog):
    """XLS-R is published as ``Wav2Vec2ForPreTraining``: the backbone under
    ``wav2vec2.`` loads, the quantizer and projections are dropped."""
    hf = _hf(dict(HF_TINY, codevector_dim=8, proj_codevector_dim=8,
                  num_codevectors_per_group=4, num_codevector_groups=2),
             "Wav2Vec2ForPreTraining")
    cfg, model = convert.load_wav2vec2(_save(hf, str(tmp_path / "ckpt")))
    assert cfg.do_normalize  # no preprocessor config: the layer-norm stem normalises
    sd = hf.wav2vec2.state_dict()
    assert torch.equal(model.state_dict()["layers.1.attention.q_w"],
                       sd["encoder.layers.1.attention.q_proj.weight"])
    assert torch.equal(model.state_dict()["feature_encoder.layers.2.norm_scale"],
                       sd["feature_extractor.conv_layers.2.layer_norm.weight"])
    with pytest.raises(OSError, match="never downloads"):
        convert.load_wav2vec2("facebook/wav2vec2-xls-r-2b")


def test_config_refuses_what_is_not_ported():
    hf = dict(HF_TINY, conv_dim=[16] * 3, hidden_act="relu")
    with pytest.raises(ValueError, match="GELU"):
        convert.wav2vec2_config_from_hf(hf)
    with pytest.raises(ValueError, match="adapters"):
        convert.wav2vec2_config_from_hf(dict(HF_TINY, add_adapter=True))


def test_config_refuses_the_base_models_post_ln_layers():
    """The port runs XLS-R's stable pre-LN layers alone. HF's
    ``Wav2Vec2Config`` defaults to the base models' post-LN ones, so a
    config.json that leaves ``do_stable_layer_norm`` out is refused too."""
    with pytest.raises(ValueError, match="post-LN"):
        convert.wav2vec2_config_from_hf(dict(HF_TINY, do_stable_layer_norm=False))
    hf = {k: v for k, v in HF_TINY.items() if k != "do_stable_layer_norm"}
    with pytest.raises(ValueError, match="post-LN"):
        convert.wav2vec2_config_from_hf(hf)


@pytest.mark.parametrize("head_dim,refused", [(8, True), (64, False), (80, True), (120, False)])
def test_extractor_refuses_heads_the_tiles_lack_on_a_card(head_dim, refused):
    """On a card the attention kernel takes head_dim 64 or 120 alone: other
    heads raise before the model moves; the CPU's plain version takes any."""
    cfg = Wav2Vec2Config.tiny(hidden_size=4 * head_dim, heads=4)
    Wav2Vec2Extractor.check_device(cfg, "cpu")
    if refused:
        with pytest.raises(ValueError, match="head_dim 64 or 120"):
            Wav2Vec2Extractor.check_device(cfg, "cuda")
        with pytest.raises(ValueError, match=f"heads of {head_dim}"):
            Wav2Vec2Extractor(Wav2Vec2Model(cfg, device="meta"), "cuda")
    else:
        Wav2Vec2Extractor.check_device(cfg, torch.device("cuda", 0))


@pytest.fixture
def fresh_logging(monkeypatch):
    """The package's logging unset for this test and restored after it:
    ``setup_logging`` configures once a process, and an earlier test of the
    worker may have done so."""
    from stutter_tpu_torch.utils import logging as tlog

    logger = logging.getLogger("stutter_tpu_torch")
    monkeypatch.setattr(tlog, "_configured", False)
    monkeypatch.setattr(tlog, "_logfile", None)
    monkeypatch.setattr(logger, "handlers", [])
    monkeypatch.setattr(logger, "level", logger.level)
    yield
    for h in logger.handlers:
        h.close()


def test_cli_refuses_heads_the_tiles_lack_before_loading(tmp_path, monkeypatch):
    """On a card, a checkpoint whose heads the kernel lacks fails before its
    weights load; XLS-R 1B (heads of 80) is no choice of ``--model_name``."""
    from stutter_tpu_torch.cli import common
    from stutter_tpu_torch.cli import extract_wav2vec2 as cli

    ckpt = _save(_hf(HF_TINY), str(tmp_path / "ckpt"), {"do_normalize": True})

    def no_load(path):
        raise AssertionError("weights loaded")

    monkeypatch.setattr(convert, "load_wav2vec2", no_load)
    with pytest.raises(ValueError, match="heads of 8"):
        common.load_wav2vec2_model(ckpt, False, "cuda")
    with pytest.raises(ValueError, match="heads of 80"):
        Wav2Vec2Extractor.check_device(Wav2Vec2Config.xls_r_1b(), "cuda")
    assert "facebook/wav2vec2-xls-r-1b" not in common.WAV2VEC2_CONFIGS
    with pytest.raises(SystemExit):
        cli.parse_args(["--data_dir", "d", "--output_dir", "o",
                        "--model_name", "facebook/wav2vec2-xls-r-1b"])


def test_cli_extracts_a_tiny_checkpoint_on_cpu(tmp_path, monkeypatch, fresh_logging):
    from stutter_tpu_torch.cli import extract_wav2vec2 as cli

    monkeypatch.chdir(tmp_path)  # the CLI's logfile goes under logs/ here
    ckpt = _save(_hf(HF_TINY), str(tmp_path / "ckpt"), {"do_normalize": True})
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 2, "test": 1, "devel": 1},
                          duration_range=(0.3, 0.6), seed=1)
    out = str(tmp_path / "out")
    rc = cli.main(["--data_dir", root, "--output_dir", out, "--model_path", ckpt,
                   "--device", "cpu", "--preset", "fidelity", "--audio_budget", "2",
                   "--batch_size", "2"])
    assert rc == 0
    assert list((tmp_path / "logs").glob("wav2vec2_embedding_*.log"))
    for split, n in (("train", 2), ("test", 1), ("devel", 1)):
        for layer in (2, 1, 0):
            arr = np.load(os.path.join(out, split, f"layer_{layer}_embeddings.npy"))
            assert arr.shape == (n, 32) and np.isfinite(arr).all()
    with pytest.raises(SystemExit, match="one device"):
        cli.main(["--data_dir", root, "--output_dir", out, "--model_path", ckpt,
                  "--device", "cpu", "--devices", "2"])
