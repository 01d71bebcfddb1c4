"""stutter_tpu_torch's HF checkpoint loading against the JAX package's converter and HF.

A random-init ``transformers`` model is saved into a local directory in each
layout a checkpoint comes in (safetensors, one file or two shards; read by
the ``safetensors`` package and by the port's own parser; ``.bin`` with both
weight-norm namings), loaded by the port, and held to:
- the JAX package's ``convert_*_state_dict`` taken through the port's
  ``*_params_from_numpy``: every tensor bit-equal;
- HF's own forward: every hidden state within 1e-5 max-abs (f32 on the CPU).
"""

import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from stutter_tpu.weights import convert as jconvert
from stutter_tpu_torch.models.verify import verify_wavlm, verify_whisper
from stutter_tpu_torch.weights import convert

torch.set_num_threads(2)  # six xdist workers share the host

FORWARD_MAX_ABS = 1e-5  # port vs HF, f32 on the CPU: the same math in another order

HF_WAVLM = dict(  # base style: group-norm stem, post-LN encoder; 4 pos-conv groups
    hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
    conv_dim=[16, 16, 16], conv_stride=[5, 2, 2], conv_kernel=[10, 3, 3],
    num_feat_extract_layers=3, conv_bias=False, feat_extract_norm="group",
    do_stable_layer_norm=False, num_buckets=64, max_bucket_distance=100,
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, layerdrop=0.0, vocab_size=32)
HF_WAVLM_LARGE = dict(HF_WAVLM, conv_bias=True, feat_extract_norm="layer",
                      do_stable_layer_norm=True)
HF_WHISPER = dict(
    d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=4,
    decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=80,
    max_source_positions=1500, max_target_positions=448, vocab_size=128, pad_token_id=0,
    bos_token_id=1, eos_token_id=2, decoder_start_token_id=3)

LAYOUTS = ["safetensors", "safetensors_by_hand", "bin", "two_shards"]


def _hf_wavlm(kwargs, cls_name="WavLMModel"):
    import transformers

    torch.manual_seed(0)
    return getattr(transformers, cls_name)(transformers.WavLMConfig(**kwargs)).eval()


def _hf_whisper():
    import transformers

    torch.manual_seed(0)
    return transformers.WhisperModel(transformers.WhisperConfig(**HF_WHISPER)).eval()


def _save(model, path, layout, weight_g_v=False):
    """Write ``model`` as an HF checkpoint directory in ``layout``."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    model.config.to_json_file(os.path.join(path, "config.json"))
    sd = {k: v.contiguous() for k, v in model.state_dict().items()}
    if weight_g_v:
        sd = {k.replace("parametrizations.weight.original0", "weight_g")
              .replace("parametrizations.weight.original1", "weight_v"): v
              for k, v in sd.items()}
    if layout == "bin":
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
        torch.save({"lr": 1.0}, os.path.join(path, "training_args.bin"))  # not weights
    elif layout == "two_shards":
        keys = sorted(sd)
        for i, part in enumerate((keys[::2], keys[1::2])):
            save_file({k: sd[k] for k in part},
                      os.path.join(path, f"model-0000{i + 1}-of-00002.safetensors"))
    else:
        save_file(sd, os.path.join(path, "model.safetensors"))
    return path


def _np_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _hide_safetensors(monkeypatch, layout=None):
    """Make ``import safetensors`` fail (a GPU host may lack it): the
    loader then parses the files itself. Returns the count of files so read."""
    parsed = []
    if layout in (None, "safetensors_by_hand"):
        # the submodule too: an import of an already imported one never
        # looks at its parent
        monkeypatch.setitem(sys.modules, "safetensors", None)
        monkeypatch.setitem(sys.modules, "safetensors.torch", None)
        real = np.fromfile
        monkeypatch.setattr(np, "fromfile", lambda *a, **k: parsed.append(a[0]) or real(*a, **k))
    return parsed


def _assert_state_equal(ours: dict, ref: dict):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and torch.equal(ours[k], ref[k]), k


@pytest.mark.parametrize("style", ["base", "large"])
@pytest.mark.parametrize("layout", LAYOUTS + ["bin_weight_g_v"])
def test_wavlm_checkpoint_matches_jax_converter(tmp_path, monkeypatch, style, layout):
    hf = _hf_wavlm(HF_WAVLM if style == "base" else HF_WAVLM_LARGE)
    path = _save(hf, str(tmp_path / "wavlm-ckpt"), layout.removesuffix("_weight_g_v"),
                 weight_g_v=layout.endswith("weight_g_v"))
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({"do_normalize": style == "large"}, f)
    parsed = _hide_safetensors(monkeypatch, layout)
    cfg, model = convert.load_wavlm(path)
    assert len(parsed) == (layout == "safetensors_by_hand")

    jcfg = jconvert.wavlm_config_from_hf(hf.config)
    tree = jconvert.convert_wavlm_state_dict(_np_state(hf), jcfg)
    _assert_state_equal(model.state_dict(), convert.wavlm_params_from_numpy(tree, cfg))
    jfields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    assert cfg == convert.WavLMConfig(**dict(jfields, do_normalize=style == "large"))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_whisper_checkpoint_matches_jax_converter(tmp_path, monkeypatch, layout):
    hf = _hf_whisper()
    path = _save(hf, str(tmp_path / "whisper-ckpt"), layout)
    parsed = _hide_safetensors(monkeypatch, layout)
    cfg, model = convert.load_whisper(path)
    assert len(parsed) == (layout == "safetensors_by_hand")

    jcfg = jconvert.whisper_config_from_hf(hf.config)
    tree = jconvert.convert_whisper_state_dict(_np_state(hf), jcfg)
    _assert_state_equal(model.state_dict(), convert.whisper_params_from_numpy(tree, cfg))
    jfields = {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    assert cfg == convert.WhisperConfig(**jfields)


@pytest.mark.parametrize("style", ["base", "large"])
def test_wavlm_forward_matches_hf(tmp_path, rng, style):
    hf = _hf_wavlm(HF_WAVLM if style == "base" else HF_WAVLM_LARGE)
    _, model = convert.load_wavlm(_save(hf, str(tmp_path / "ckpt"), "safetensors"))
    wave = (rng.randn(2, 3200) * 0.1).astype(np.float32)
    with torch.no_grad():
        golden = hf(torch.from_numpy(wave), output_hidden_states=True).hidden_states
    _, ours, _ = model(torch.from_numpy(wave))
    assert ours.shape[0] == len(golden) == model.cfg.num_hidden_layers + 1
    for i, g in enumerate(golden):
        err = float((ours[i] - g).abs().max())
        assert err <= FORWARD_MAX_ABS, (i, err)


def test_whisper_forward_matches_hf(tmp_path, rng):
    hf = _hf_whisper()
    _, model = convert.load_whisper(_save(hf, str(tmp_path / "ckpt"), "safetensors"))
    mel = torch.from_numpy((rng.randn(2, 80, 3000) * 0.5).astype(np.float32))
    with torch.no_grad():
        enc = hf.encoder(mel, output_hidden_states=True)
        dec = hf.decoder(input_ids=torch.zeros((2, 1), dtype=torch.long),
                         encoder_hidden_states=enc.last_hidden_state,
                         output_hidden_states=True)
    _, enc_states, _, dec_states = model(mel)
    for ours, golden in ((enc_states, enc.hidden_states), (dec_states, dec.hidden_states)):
        assert ours.shape[0] == len(golden)
        for i, g in enumerate(golden):
            err = float((ours[i] - g).abs().max())
            assert err <= FORWARD_MAX_ABS, (i, err)


@pytest.mark.parametrize("dtype", ["F32", "F16", "BF16", "I64"])
def test_safetensors_parser_matches_the_package(tmp_path, monkeypatch, rng, dtype):
    from safetensors.torch import save_file

    torch_dtype = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                   "I64": torch.int64}[dtype]
    tensors = {"a": torch.from_numpy(rng.randn(3, 5).astype(np.float32) * 100).to(torch_dtype),
               "b.c": torch.arange(7).to(torch_dtype), "empty": torch.zeros(0, 4, dtype=torch_dtype)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    with_package = convert.read_safetensors(path)
    parsed = _hide_safetensors(monkeypatch)
    by_hand = convert.read_safetensors(path)
    assert parsed == [path]
    assert sorted(by_hand) == sorted(with_package) == sorted(tensors)
    for k, t in tensors.items():
        ref = (t.float() if dtype == "BF16" else t).numpy()
        for got in (by_hand[k], with_package[k]):
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)


def test_hub_names_raise_naming_a_local_directory():
    for load in (convert.load_wavlm, convert.load_whisper):
        with pytest.raises(OSError, match="local checkpoint directory"):
            load("microsoft/wavlm-large")


def test_missing_and_left_over_keys_raise_and_name_the_key(tmp_path):
    hf = _hf_wavlm(HF_WAVLM)
    sd = _np_state(hf)
    cfg = convert.wavlm_config_from_hf(hf.config.to_dict())
    missing = dict(sd)
    del missing["encoder.layers.1.attention.q_proj.bias"]
    with pytest.raises(KeyError, match="encoder.layers.1.attention.q_proj.bias"):
        convert.convert_wavlm_state_dict(missing, cfg)
    with pytest.raises(ValueError, match="encoder.layers.9.extra"):
        convert.convert_wavlm_state_dict(dict(sd, **{"encoder.layers.9.extra": sd["masked_spec_embed"]}), cfg)
    wcfg = convert.whisper_config_from_hf(_hf_whisper().config.to_dict())
    wsd = _np_state(_hf_whisper())
    del wsd["decoder.layers.0.encoder_attn.v_proj.bias"]
    with pytest.raises(KeyError, match="decoder.layers.0.encoder_attn.v_proj.bias"):
        convert.convert_whisper_state_dict(wsd, wcfg)
    (tmp_path / "empty").mkdir()
    with pytest.raises(OSError, match="no .*safetensors"):
        convert._load_state_dict_from_dir(str(tmp_path / "empty"))


def test_task_model_checkpoint_keeps_the_backbone(tmp_path):
    """A WavLMForCTC checkpoint: the ``wavlm.`` entries load, the head's are
    dropped; the backbone equals the JAX converter's."""
    hf = _hf_wavlm(HF_WAVLM, "WavLMForCTC")
    path = _save(hf, str(tmp_path / "ctc"), "safetensors")
    cfg, model = convert.load_wavlm(path)
    jcfg = jconvert.wavlm_config_from_hf(hf.config)
    tree = jconvert.convert_wavlm_state_dict(_np_state(hf), jcfg)
    _assert_state_equal(model.state_dict(), convert.wavlm_params_from_numpy(tree, cfg))


def test_do_normalize_from_the_name_without_preprocessor_config(tmp_path, caplog):
    hf = _hf_wavlm(HF_WAVLM)
    with caplog.at_level(logging.WARNING):
        cfg, _ = convert.load_wavlm(_save(hf, str(tmp_path / "my-wavlm-large"), "safetensors"))
        assert cfg.do_normalize is True
        cfg, _ = convert.load_wavlm(_save(hf, str(tmp_path / "my-wavlm-base"), "safetensors"))
        assert cfg.do_normalize is False
    assert sum("inferring do_normalize" in r.message for r in caplog.records) == 2


def test_verify_checks_hidden_sizes(tmp_path, caplog):
    _, wavlm = convert.load_wavlm(_save(_hf_wavlm(HF_WAVLM), str(tmp_path / "w"), "bin"))
    _, whisper = convert.load_whisper(_save(_hf_whisper(), str(tmp_path / "h"), "bin"))
    with caplog.at_level(logging.INFO):
        assert verify_wavlm(wavlm, "my/tiny") == 3
        assert verify_whisper(whisper, "my/tiny") == (3, 3)
    assert any("WavLM verified: 3 hidden states of [1, " in r.message for r in caplog.records)
    with pytest.raises(ValueError, match="not 1024"):
        verify_wavlm(wavlm, "microsoft/wavlm-large")
    with pytest.raises(ValueError, match="not 768"):
        verify_wavlm(wavlm, "microsoft/wavlm-base")
    with pytest.raises(ValueError, match="not 1280"):
        verify_whisper(whisper, "openai/whisper-large")


@pytest.mark.parametrize("entry", ["extract_wavlm", "extract_whisper"])
def test_extraction_clis_load_a_local_checkpoint(tmp_path, caplog, entry):
    """The extraction CLIs on a local checkpoint directory (--model_path,
    --verify_model) write the store the JAX package's pipeline writes from
    its own converter's weights (rows within 1e-5 cosine, f32)."""
    import jax

    from stutter_tpu.audio.synthetic import make_synthetic_corpus
    from stutter_tpu.extract import BucketBatcher as JaxBatcher
    from stutter_tpu.extract import ExtractionPipeline as JaxPipeline
    from stutter_tpu.extract import WavLMExtractor as JaxWavLM
    from stutter_tpu.extract import WhisperExtractor as JaxWhisper
    from stutter_tpu.extract import create_metadata_from_files as jax_scan
    from stutter_tpu_torch.cli import extract_wavlm, extract_whisper
    from tests.conftest import cosine_distance

    wavlm = entry == "extract_wavlm"
    hf = _hf_wavlm(HF_WAVLM_LARGE) if wavlm else _hf_whisper()
    ckpt = _save(hf, str(tmp_path / "ckpt"), "safetensors")
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 3}, duration_range=(0.3, 0.9), seed=4)
    out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--data_dir", root, "--output_dir", out, "--model_path", ckpt, "--verify_model",
            "--device", "cpu", "--preset", "fidelity", "--split", "train", "--batch_size", "4"]
    with caplog.at_level(logging.INFO):
        if wavlm:
            rc = extract_wavlm.main(argv + ["--audio_budget", "4", "--max_length", "1.0"])
        else:
            rc = extract_whisper.main(argv)
    assert rc == 0
    assert any("verified" in r.message for r in caplog.records)

    if wavlm:
        jcfg = jconvert.wavlm_config_from_hf(hf.config)
        params = jconvert.convert_wavlm_state_dict(_np_state(hf), jcfg)
        ex = JaxWavLM(jcfg, jax.tree.map(np.asarray, params), preset="fidelity")
        batcher = JaxBatcher(audio_budget_s=4.0, max_batch=4, max_length_s=1.0,
                             frame_align=ex.frame_align)
    else:
        jcfg = jconvert.whisper_config_from_hf(hf.config)
        params = jconvert.convert_whisper_state_dict(_np_state(hf), jcfg)
        ex = JaxWhisper(jcfg, jax.tree.map(np.asarray, params), preset="fidelity")
        batcher = JaxBatcher(buckets_s=(30.0,), audio_budget_s=120.0, max_batch=4)
    JaxPipeline(ex, batcher=batcher).run_split(jax_scan(root, split="train"), "train", jax_out)
    for col in ex.column_names:
        ours = np.load(os.path.join(out, "train", f"{col}_embeddings.npy"))
        ref = np.load(os.path.join(jax_out, "train", f"{col}_embeddings.npy"))
        assert ours.shape == ref.shape == (3, 32)
        assert max(cosine_distance(a, b) for a, b in zip(ours, ref)) <= 1e-5, col


def test_train_and_finetune_clis_load_a_local_checkpoint(tmp_path):
    """cli.train's re-extraction model and cli.finetune's backbone come from
    a local checkpoint directory (a Whisper one whatever its name)."""
    from stutter_tpu.audio.synthetic import make_synthetic_corpus
    from stutter_tpu_torch.cli import finetune
    from stutter_tpu_torch.cli.train import build_extractor_for

    wavlm_dir = _save(_hf_wavlm(HF_WAVLM), str(tmp_path / "w"), "safetensors")
    whisper_dir = _save(_hf_whisper(), str(tmp_path / "local-asr"), "bin")
    ex = build_extractor_for("wavlm", wavlm_dir, False, "cpu", "fidelity")
    _assert_state_equal(ex.model.state_dict(), convert.load_wavlm(wavlm_dir)[1].state_dict())
    ex = build_extractor_for("whisper", whisper_dir, False, "cpu", "fidelity")
    _assert_state_equal(ex.model.state_dict(), convert.load_whisper(whisper_dir)[1].state_dict())

    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, n_per_split={"train": 4, "test": 2}, duration_range=(0.3, 0.6),
                          seed=6)
    results = str(tmp_path / "results")
    assert finetune.main(["--data_dir", root, "--results_dir", results, "--model_path",
                          wavlm_dir, "--epochs", "1", "--batch_size", "4", "--max_length", "1.0",
                          "--device", "cpu"]) == 0
    saved = np.load(os.path.join(results, "wavlm_finetune_weighted_sum_mlp_model.npz"))
    assert saved["backbone/encoder/layers/q_w"].shape == (2, 32, 32)
