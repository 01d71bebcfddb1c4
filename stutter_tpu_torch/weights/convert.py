"""WavLM and Whisper parameters for the port: from the JAX package's pytree, or seeded.

``wavlm_params_from_numpy`` and ``whisper_params_from_numpy`` map the
parameter pytree of ``stutter_tpu.models.wavlm.init_wavlm_params`` /
``stutter_tpu.models.whisper.init_whisper_params`` (or of the JAX package's
HF converters), given as numpy arrays, onto ``WavLMModel``'s /
``WhisperModel``'s state dict: the stacked leading layer axis is split into
one entry per layer, and dense weights go from JAX's [in, out] to PyTorch's
[out, in]. Every leaf must be used exactly once.

``finetune_params_from_numpy`` maps the JAX fine-tune tree
(``{"backbone", "layer_weights", "head": [{"w", "b"}, ...]}``) onto
``train.finetune.FinetuneModel``'s state dict; ``finetune_params_to_numpy``
(with ``wavlm_params_to_numpy``) is its inverse, for saving a fine-tuned model
keyed by the JAX tree's paths.

``init_wavlm``, ``init_wav2vec2``, ``init_w2v_bert`` and ``init_whisper`` build a
model with a seeded random init drawn like the JAX package's (normal *
fan_in^-0.5 weights, zero biases, unit norm scales), from a
``torch.Generator`` on the CPU so that the same seed gives the same weights
on every device.

``load_wavlm`` and ``load_whisper`` read a local HF checkpoint directory
(``config.json``, the weights as ``*.safetensors`` or ``pytorch_model*.bin``
shards, and for WavLM ``preprocessor_config.json``) into a float32 model,
as the JAX package's loaders of the same names do, without ``transformers``:
``read_safetensors`` parses the files by hand where the ``safetensors``
package is missing. ``load_wav2vec2`` does the same for wav2vec 2.0 / XLS-R
(``Wav2Vec2Model``, ``Wav2Vec2ForPreTraining`` or a task model's backbone),
which the JAX package lacks, and ``load_w2v_bert`` for w2v-BERT 2.0
(``Wav2Vec2BertModel`` or a task model's backbone; the frontend's sizes from
``preprocessor_config.json``), which it lacks too. ``convert_wavlm_state_dict``,
``convert_wav2vec2_state_dict``, ``convert_w2v_bert_state_dict`` and
``convert_whisper_state_dict`` map an HF state dict onto the port's: dense
weights stay [out, in], the positional conv's weight norm is folded in
float64, and every HF key of the backbone must be used exactly once. They
never download: a name that is not a local directory raises ``OSError``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Mapping

import numpy as np
import torch

from stutter_tpu_torch.models.w2v_bert import W2VBertConfig, W2VBertModel
from stutter_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel, sinusoids

logger = logging.getLogger("stutter_tpu_torch.weights")

# per-layer JAX key -> (port name under layers.{i}, transpose [in, out] -> [out, in])
_LAYER_KEYS = {
    "q_w": ("attention.q_w", True), "q_b": ("attention.q_b", False),
    "k_w": ("attention.k_w", True), "k_b": ("attention.k_b", False),
    "v_w": ("attention.v_w", True), "v_b": ("attention.v_b", False),
    "o_w": ("attention.o_w", True), "o_b": ("attention.o_b", False),
    "gru_w": ("attention.gru_w", True), "gru_b": ("attention.gru_b", False),
    "gru_const": ("attention.gru_const", False),
    "ff_w1": ("feed_forward.w1", True), "ff_b1": ("feed_forward.b1", False),
    "ff_w2": ("feed_forward.w2", True), "ff_b2": ("feed_forward.b2", False),
    "ln1_s": ("ln1_s", False), "ln1_b": ("ln1_b", False),
    "ln2_s": ("ln2_s", False), "ln2_b": ("ln2_b", False),
}


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a/b/0/c": leaf}; None leaves are absent."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix: np.asarray(tree)}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


class _Leaves:
    """The flattened leaves of a pytree, each to be taken exactly once."""

    def __init__(self, tree: Any):
        self.leaves = flatten_tree(tree)
        self.used: set[str] = set()

    def __call__(self, path: str, transpose: bool = False) -> torch.Tensor:
        a = self.array(path)
        return torch.from_numpy(np.array(a.T if transpose else a, order="C"))

    def array(self, path: str) -> np.ndarray:
        """The leaf itself (not copied), marked as used."""
        if path not in self.leaves:
            raise KeyError(f"parameter tree has no leaf {path!r}")
        self.used.add(path)
        return self.leaves[path]

    def stacked(self, path: str, n_layers: int) -> torch.Tensor:
        t = self(path)
        if t.shape[0] != n_layers:
            raise ValueError(f"{path} stacks {t.shape[0]} layers, config has {n_layers}")
        return t

    def check_all_used(self) -> None:
        unused = sorted(set(self.leaves) - self.used)
        if unused:
            raise ValueError(f"parameter tree leaves not used by the model: {unused}")


def wavlm_params_from_numpy(tree: Any, cfg: WavLMConfig) -> dict[str, torch.Tensor]:
    """JAX WavLM parameter pytree (numpy leaves) -> ``WavLMModel`` state dict.

    Raises KeyError if a leaf the model needs is missing and ValueError if a
    leaf is left unused."""
    take = _Leaves(tree)
    state: dict[str, torch.Tensor] = {}
    for i in range(len(cfg.conv_dim)):
        src, dst = f"feature_encoder/conv_layers/{i}", f"feature_encoder.layers.{i}"
        state[f"{dst}.weight"] = take(f"{src}/w")
        if cfg.conv_bias:
            state[f"{dst}.bias"] = take(f"{src}/b")
        if _conv_has_norm(cfg, i):
            state[f"{dst}.norm_scale"] = take(f"{src}/norm/scale")
            state[f"{dst}.norm_bias"] = take(f"{src}/norm/bias")
    state["feature_projection.ln_scale"] = take("feature_projection/ln/scale")
    state["feature_projection.ln_bias"] = take("feature_projection/ln/bias")
    state["feature_projection.weight"] = take("feature_projection/w", transpose=True)
    state["feature_projection.bias"] = take("feature_projection/b")
    state["pos_conv.weight"] = take("encoder/pos_conv/w")
    state["pos_conv.bias"] = take("encoder/pos_conv/b")
    state["ln_scale"] = take("encoder/ln/scale")
    state["ln_bias"] = take("encoder/ln/bias")
    state["rel_attn_embed"] = take("encoder/rel_attn_embed")
    state["masked_spec_embed"] = take("masked_spec_embed")
    for key, (name, transpose) in _LAYER_KEYS.items():
        stacked = take.stacked(f"encoder/layers/{key}", cfg.num_hidden_layers)
        for layer in range(cfg.num_hidden_layers):
            t = stacked[layer]
            state[f"layers.{layer}.{name}"] = t.T.contiguous() if transpose else t
    take.check_all_used()
    return state


def _conv_has_norm(cfg: WavLMConfig, i: int) -> bool:
    return cfg.feat_extract_norm == "layer" or (cfg.feat_extract_norm == "group" and i == 0)


def wavlm_params_to_numpy(state: Mapping[str, torch.Tensor], cfg: WavLMConfig) -> dict:
    """``WavLMModel`` state dict -> the JAX WavLM parameter pytree (numpy
    leaves; per-layer entries stacked, dense weights back to [in, out]).
    The inverse of ``wavlm_params_from_numpy``; every entry must be used."""
    used: set[str] = set()

    def take(name, transpose=False):
        used.add(name)
        t = state[name].detach().float().cpu().numpy()
        return np.ascontiguousarray(t.T if transpose else t)

    conv_layers = []
    for i in range(len(cfg.conv_dim)):
        src = f"feature_encoder.layers.{i}"
        layer = {"w": take(f"{src}.weight"),
                 "b": take(f"{src}.bias") if cfg.conv_bias else None}
        if _conv_has_norm(cfg, i):
            layer["norm"] = {"scale": take(f"{src}.norm_scale"),
                             "bias": take(f"{src}.norm_bias")}
        conv_layers.append(layer)
    layers = {key: np.stack([take(f"layers.{i}.{name}", transpose)
                             for i in range(cfg.num_hidden_layers)])
              for key, (name, transpose) in _LAYER_KEYS.items()}
    tree = {
        "masked_spec_embed": take("masked_spec_embed"),
        "feature_encoder": {"conv_layers": conv_layers},
        "feature_projection": {
            "ln": {"scale": take("feature_projection.ln_scale"),
                   "bias": take("feature_projection.ln_bias")},
            "w": take("feature_projection.weight", transpose=True),
            "b": take("feature_projection.bias"),
        },
        "encoder": {
            "pos_conv": {"w": take("pos_conv.weight"), "b": take("pos_conv.bias")},
            "ln": {"scale": take("ln_scale"), "bias": take("ln_bias")},
            "rel_attn_embed": take("rel_attn_embed"),
            "layers": layers,
        },
    }
    unused = sorted(set(state) - used)
    if unused:
        raise ValueError(f"state dict entries not in the JAX tree: {unused}")
    return tree


def finetune_params_from_numpy(tree: Any, cfg: WavLMConfig) -> dict[str, torch.Tensor]:
    """JAX fine-tune tree ``{"backbone", "layer_weights", "head": [{"w", "b"},
    ...]}`` (numpy leaves) -> ``FinetuneModel`` state dict. The head's
    weights keep the JAX layout [in, out]. Raises KeyError for a missing leaf
    and ValueError for an unused one."""
    extra = sorted(set(tree) - {"backbone", "layer_weights", "head"})
    if extra:
        raise ValueError(f"parameter tree leaves not used by the model: {extra}")
    state = {f"backbone.{k}": v for k, v in
             wavlm_params_from_numpy(tree["backbone"], cfg).items()}
    take = _Leaves({"layer_weights": tree["layer_weights"], "head": tree["head"]})
    state["layer_weights"] = take("layer_weights")
    if state["layer_weights"].shape != (cfg.num_hidden_layers + 1,):
        raise ValueError(f"layer_weights {tuple(state['layer_weights'].shape)} for "
                         f"{cfg.num_hidden_layers + 1} hidden states")
    for i in range(len(tree["head"])):
        state[f"head.layers.{i}.w"] = take(f"head/{i}/w")
        state[f"head.layers.{i}.b"] = take(f"head/{i}/b")
    take.check_all_used()
    return state


def finetune_params_to_numpy(state: Mapping[str, torch.Tensor], cfg: WavLMConfig) -> dict:
    """``FinetuneModel`` state dict -> the JAX fine-tune tree (numpy leaves):
    the inverse of ``finetune_params_from_numpy``."""
    prefix = "backbone."
    backbone = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    n_head = len([k for k in state if k.startswith("head.layers.") and k.endswith(".w")])
    head = [{"w": state[f"head.layers.{i}.w"].detach().float().cpu().numpy(),
             "b": state[f"head.layers.{i}.b"].detach().float().cpu().numpy()}
            for i in range(n_head)]
    head_keys = {f"head.layers.{i}.{w}" for i in range(n_head) for w in ("w", "b")}
    unused = sorted(k for k in state if not k.startswith(prefix)
                    and k != "layer_weights" and k not in head_keys)
    if unused:
        raise ValueError(f"state dict entries not in the JAX tree: {unused}")
    return {"backbone": wavlm_params_to_numpy(backbone, cfg),
            "layer_weights": state["layer_weights"].detach().float().cpu().numpy(),
            "head": head}


def _whisper_layer_name(key: str) -> str:
    """Stacked JAX layer key -> the port's name under ``layers.{i}``:
    attn_q_w -> attn.q_w, xattn_v_b -> xattn.v_b, fc1_w -> ffn.fc1_w,
    ln1_s -> ln1_s."""
    prefix, _, rest = key.partition("_")
    if prefix in ("attn", "xattn"):
        return f"{prefix}.{rest}"
    if prefix in ("fc1", "fc2"):
        return f"ffn.{key}"
    return key


def whisper_params_from_numpy(tree: Any, cfg: WhisperConfig) -> dict[str, torch.Tensor]:
    """JAX Whisper parameter pytree (numpy leaves) -> ``WhisperModel`` state dict.

    Raises KeyError if a leaf the model needs is missing and ValueError if a
    leaf is left unused."""
    take = _Leaves(tree)
    state: dict[str, torch.Tensor] = {}
    for name in ("conv1_w", "conv1_b", "conv2_w", "conv2_b", "pos_embed", "ln_s", "ln_b"):
        state[f"encoder.{name}"] = take(f"encoder/{name}")  # convs are [out, in, k] in both
    for name in ("embed_tokens", "pos_embed", "ln_s", "ln_b"):
        state[f"decoder.{name}"] = take(f"decoder/{name}")
    template = WhisperModel(cfg, device="meta").state_dict()
    for block, n_layers in (("encoder", cfg.encoder_layers), ("decoder", cfg.decoder_layers)):
        prefix = f"{block}/layers/"
        for path in [p for p in take.leaves if p.startswith(prefix)]:
            key = path[len(prefix):]
            stacked = take.stacked(path, n_layers)
            name = _whisper_layer_name(key)
            for layer in range(n_layers):
                t = stacked[layer]
                # dense weights are [in, out] in JAX, [out, in] here
                state[f"{block}.layers.{layer}.{name}"] = (
                    t.T.contiguous() if key.endswith("_w") else t)
    take.check_all_used()
    missing = sorted(set(template) - set(state))
    if missing:
        raise KeyError(f"parameter tree has no leaves for {missing}")
    extra = sorted(set(state) - set(template))
    if extra:
        raise ValueError(f"parameter tree leaves not used by the model: {extra}")
    return state


@torch.no_grad()
def init_wavlm(cfg: WavLMConfig, generator: torch.Generator,
               device: torch.device | str | None = None) -> WavLMModel:
    """A float32 ``WavLMModel`` on ``device`` with a seeded random init."""
    return _seeded_init(WavLMModel, cfg, generator, device)


def init_wav2vec2(cfg: Wav2Vec2Config, generator: torch.Generator,
                  device: torch.device | str | None = None) -> Wav2Vec2Model:
    """A float32 ``Wav2Vec2Model`` on ``device`` with ``init_wavlm``'s
    seeded random init."""
    return _seeded_init(Wav2Vec2Model, cfg, generator, device)


def _seeded_init(model_cls, cfg, generator: torch.Generator, device):
    model = model_cls(cfg, device="meta")

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    state: dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        shape, leaf = tuple(p.shape), name.rsplit(".", 1)[-1]
        if leaf in ("norm_scale", "ln_scale", "ln1_s", "ln2_s", "gru_const") or leaf.endswith(
                "ln_s"):  # w2v-BERT's norm scales
            state[name] = torch.ones(shape)
        elif name == "rel_attn_embed":
            state[name] = normal(shape, 0.02)
        elif name == "masked_spec_embed":
            state[name] = torch.rand(shape, generator=generator)
        elif p.dim() == 3:  # conv [out, in, k]
            state[name] = normal(shape, (shape[1] * shape[2]) ** -0.5)
        elif p.dim() == 2:  # dense [out, in]
            state[name] = normal(shape, shape[1] ** -0.5)
        else:  # biases and norm shifts
            state[name] = torch.zeros(shape)
    model = model_cls(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model


def init_w2v_bert(cfg: W2VBertConfig, generator: torch.Generator,
                  device: torch.device | str | None = None) -> W2VBertModel:
    """A float32 ``W2VBertModel`` on ``device`` with ``init_wavlm``'s seeded
    random init (the distance embeddings normal * 64^-1/2, as a dense
    weight's)."""
    return _seeded_init(W2VBertModel, cfg, generator, device)


@torch.no_grad()
def init_whisper(cfg: WhisperConfig, generator: torch.Generator,
                 device: torch.device | str | None = None) -> WhisperModel:
    """A float32 ``WhisperModel`` on ``device`` with a seeded random init,
    drawn like ``init_whisper_params``: dense and conv weights normal *
    fan_in^-0.5, token and decoder position embeddings normal * 0.02, the
    encoder's positions sinusoidal, zero biases, unit norm scales."""
    model = WhisperModel(cfg, device="meta")

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    state: dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        shape, leaf = tuple(p.shape), name.rsplit(".", 1)[-1]
        if name == "encoder.pos_embed":
            state[name] = torch.from_numpy(sinusoids(*shape))
        elif name in ("decoder.embed_tokens", "decoder.pos_embed"):
            state[name] = normal(shape, 0.02)
        elif leaf.startswith("ln") and leaf.endswith("_s"):
            state[name] = torch.ones(shape)
        elif p.dim() == 3:  # conv [out, in, k]
            state[name] = normal(shape, (shape[1] * shape[2]) ** -0.5)
        elif p.dim() == 2:  # dense [out, in]
            state[name] = normal(shape, shape[1] ** -0.5)
        else:  # biases and norm shifts
            state[name] = torch.zeros(shape)
    model = WhisperModel(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model


# ---------------------------------------------------------------------------
# HF checkpoints: a local directory -> the port's state dicts
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
                       "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy; bfloat16 (which numpy lacks) widened exactly to
    float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """One ``.safetensors`` file as {name: numpy array}, bfloat16 widened to
    float32. Read by the ``safetensors`` package where it imports, else
    parsed here: 8 bytes of little-endian header length, the JSON header
    (dtype, shape, ``data_offsets`` into the data that follows it)."""
    try:
        from safetensors.torch import load_file
    except ImportError:
        load_file = None
    if load_file is not None:
        return {k: _to_numpy(v) for k, v in load_file(path).items()}
    raw = np.fromfile(path, np.uint8)
    n = int.from_bytes(raw[:8].tobytes(), "little")
    header = json.loads(raw[8: 8 + n].tobytes())
    data = raw[8 + n:]
    out: dict[str, np.ndarray] = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        begin, end = entry["data_offsets"]
        chunk, shape = data[begin:end], tuple(entry["shape"])
        if entry["dtype"] == "BF16":
            bits = chunk.view("<u2").astype(np.uint32) << 16
            out[name] = bits.view(np.float32).reshape(shape)
        elif entry["dtype"] in _SAFETENSORS_DTYPES:
            out[name] = chunk.view(_SAFETENSORS_DTYPES[entry["dtype"]]).reshape(shape).copy()
        else:
            raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}, "
                             f"which this reader does not take")
    return out


def _load_state_dict_from_dir(path: str) -> dict[str, np.ndarray]:
    """A checkpoint directory's weights as {name: numpy array}: every
    ``*.safetensors`` file in sorted order (so shards combine), else the
    ``pytorch_model*.bin`` / ``model*.bin`` shards through ``torch.load``
    (a Trainer directory's other ``.bin`` files, and any file that is not a
    state dict, are skipped)."""
    files = sorted(os.listdir(path))
    sd: dict[str, np.ndarray] = {}
    safetensors = [f for f in files if f.endswith(".safetensors")]
    if safetensors:
        for f in safetensors:
            sd.update(read_safetensors(os.path.join(path, f)))
        return sd
    bins = [f for f in files if f.endswith(".bin") and f.startswith(("pytorch_model", "model"))]
    for f in bins:
        loaded = torch.load(os.path.join(path, f), map_location="cpu", weights_only=True)
        if not isinstance(loaded, Mapping):
            logger.warning("skipping non-state-dict file %s", f)
            continue
        sd.update({k: _to_numpy(v) for k, v in loaded.items()})
    if not sd:
        raise OSError(f"no *.safetensors or pytorch_model*.bin weights in {path}")
    return sd


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _local_dir(name: str) -> str:
    if not os.path.isdir(name):
        raise OSError(
            f"{name!r} is not a local checkpoint directory: this package loads HF "
            f"checkpoints only from a local checkpoint directory (config.json and the "
            f"weights) and never downloads; pass that directory, or --random_init")
    return name


def _backbone(sd: Mapping[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    """The backbone's entries of an HF state dict. A task model's checkpoint
    (WavLMForCTC, WhisperForConditionalGeneration, ...) keeps the backbone
    under ``prefix``: those keys lose the prefix and the head's are dropped."""
    if not any(k.startswith(prefix) for k in sd):
        return dict(sd)
    head = sorted(k for k in sd if not k.startswith(prefix))
    if head:
        logger.info("dropping the task head's entries %s", head)
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def wavlm_config_from_hf(hf: Mapping) -> WavLMConfig:
    """``WavLMConfig`` from an HF ``config.json`` (as a dict)."""
    return WavLMConfig(
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        conv_dim=tuple(hf["conv_dim"]),
        conv_stride=tuple(hf["conv_stride"]),
        conv_kernel=tuple(hf["conv_kernel"]),
        conv_bias=hf["conv_bias"],
        feat_extract_norm=hf["feat_extract_norm"],
        do_stable_layer_norm=hf["do_stable_layer_norm"],
        num_conv_pos_embeddings=hf["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=hf["num_conv_pos_embedding_groups"],
        num_buckets=hf["num_buckets"],
        max_bucket_distance=hf["max_bucket_distance"],
        layer_norm_eps=hf["layer_norm_eps"],
    )


def wav2vec2_config_from_hf(hf: Mapping) -> Wav2Vec2Config:
    """``Wav2Vec2Config`` from an HF ``config.json`` (as a dict). Raises
    ``ValueError`` for what the port does not compute: an activation other
    than GELU, an adapter, a convolutional relative position embedding or
    the post-LN layers of the base models (HF's default)."""
    for key in ("hidden_act", "feat_extract_activation"):
        if hf.get(key, "gelu") != "gelu":
            raise ValueError(f"{key} is {hf[key]!r}; the port computes GELU only")
    if hf.get("add_adapter") or hf.get("position_embeddings_type", "relative") != "relative":
        raise ValueError("adapters and other position embeddings are not ported")
    if not hf.get("do_stable_layer_norm", False):
        raise ValueError("post-LN layers (do_stable_layer_norm false) are not ported; "
                         "the port runs the stable pre-LN layers of XLS-R and the large models")
    return Wav2Vec2Config(
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        conv_dim=tuple(hf["conv_dim"]),
        conv_stride=tuple(hf["conv_stride"]),
        conv_kernel=tuple(hf["conv_kernel"]),
        conv_bias=hf["conv_bias"],
        feat_extract_norm=hf["feat_extract_norm"],
        num_conv_pos_embeddings=hf["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=hf["num_conv_pos_embedding_groups"],
        layer_norm_eps=hf["layer_norm_eps"],
    )


def whisper_config_from_hf(hf: Mapping) -> WhisperConfig:
    """``WhisperConfig`` from an HF ``config.json`` (as a dict)."""
    return WhisperConfig(
        d_model=hf["d_model"],
        encoder_layers=hf["encoder_layers"],
        encoder_attention_heads=hf["encoder_attention_heads"],
        decoder_layers=hf["decoder_layers"],
        decoder_attention_heads=hf["decoder_attention_heads"],
        ffn_dim=hf["encoder_ffn_dim"],
        num_mel_bins=hf["num_mel_bins"],
        max_source_positions=hf["max_source_positions"],
        max_target_positions=hf["max_target_positions"],
        vocab_size=hf["vocab_size"],
    )


def _pos_conv_weight(take: _Leaves, prefix: str) -> torch.Tensor:
    """The positional conv's weight norm folded into a plain weight [out,
    in/groups, k]: g * v / ||v||, the norm over dims (0, 1) for each kernel
    position (torch's weight_norm(dim=2)), taken in float64 as the JAX
    converter takes it."""
    if f"{prefix}.parametrizations.weight.original0" in take.leaves:
        g = take.array(f"{prefix}.parametrizations.weight.original0")
        v = take.array(f"{prefix}.parametrizations.weight.original1")
    else:
        g, v = take.array(f"{prefix}.weight_g"), take.array(f"{prefix}.weight_v")
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True))
    return torch.from_numpy((g * v / norm).astype(v.dtype))


# port name under layers.{i} -> HF name under encoder.layers.{i}
_HF_WAVLM_LAYER = {
    "attention.q_w": "attention.q_proj.weight", "attention.q_b": "attention.q_proj.bias",
    "attention.k_w": "attention.k_proj.weight", "attention.k_b": "attention.k_proj.bias",
    "attention.v_w": "attention.v_proj.weight", "attention.v_b": "attention.v_proj.bias",
    "attention.o_w": "attention.out_proj.weight", "attention.o_b": "attention.out_proj.bias",
    "attention.gru_w": "attention.gru_rel_pos_linear.weight",
    "attention.gru_b": "attention.gru_rel_pos_linear.bias",
    "feed_forward.w1": "feed_forward.intermediate_dense.weight",
    "feed_forward.b1": "feed_forward.intermediate_dense.bias",
    "feed_forward.w2": "feed_forward.output_dense.weight",
    "feed_forward.b2": "feed_forward.output_dense.bias",
    "ln1_s": "layer_norm.weight", "ln1_b": "layer_norm.bias",
    "ln2_s": "final_layer_norm.weight", "ln2_b": "final_layer_norm.bias",
}


def convert_wavlm_state_dict(sd: Mapping[str, np.ndarray],
                             cfg: WavLMConfig) -> dict[str, torch.Tensor]:
    """HF ``WavLMModel`` state dict (numpy values; a task model's with its
    ``wavlm.`` prefix) -> ``WavLMModel``'s. Raises KeyError for a missing
    entry and ValueError for one left over, naming it. A checkpoint without
    ``masked_spec_embed`` (HF makes it only where SpecAugment is on) gets a
    zero one: extraction never reads it."""
    take = _Leaves(_backbone(sd, "wavlm."))
    state: dict[str, torch.Tensor] = {}
    _convert_stem(take, cfg, state)
    state["rel_attn_embed"] = take("encoder.layers.0.attention.rel_attn_embed.weight")
    for layer in range(cfg.num_hidden_layers):
        src = f"encoder.layers.{layer}"
        for name, hf_name in _HF_WAVLM_LAYER.items():
            state[f"layers.{layer}.{name}"] = take(f"{src}.{hf_name}")
        state[f"layers.{layer}.attention.gru_const"] = take(
            f"{src}.attention.gru_rel_pos_const").reshape(-1)
    take.check_all_used()
    return state


def _convert_stem(take: _Leaves, cfg, state: dict[str, torch.Tensor]) -> None:
    """The conv stem and the feature projection, which WavLM and wav2vec2
    checkpoints name alike."""
    for i in range(len(cfg.conv_dim)):
        src, dst = f"feature_extractor.conv_layers.{i}", f"feature_encoder.layers.{i}"
        state[f"{dst}.weight"] = take(f"{src}.conv.weight")
        if cfg.conv_bias:
            state[f"{dst}.bias"] = take(f"{src}.conv.bias")
        if _conv_has_norm(cfg, i):
            state[f"{dst}.norm_scale"] = take(f"{src}.layer_norm.weight")
            state[f"{dst}.norm_bias"] = take(f"{src}.layer_norm.bias")
    state["feature_projection.ln_scale"] = take("feature_projection.layer_norm.weight")
    state["feature_projection.ln_bias"] = take("feature_projection.layer_norm.bias")
    state["feature_projection.weight"] = take("feature_projection.projection.weight")
    state["feature_projection.bias"] = take("feature_projection.projection.bias")
    state["pos_conv.weight"] = _pos_conv_weight(take, "encoder.pos_conv_embed.conv")
    state["pos_conv.bias"] = take("encoder.pos_conv_embed.conv.bias")
    state["ln_scale"] = take("encoder.layer_norm.weight")
    state["ln_bias"] = take("encoder.layer_norm.bias")
    if "masked_spec_embed" in take.leaves:
        state["masked_spec_embed"] = take("masked_spec_embed")
    else:
        logger.info("the checkpoint has no masked_spec_embed: using zeros")
        state["masked_spec_embed"] = torch.zeros(cfg.hidden_size)


def convert_wav2vec2_state_dict(sd: Mapping[str, np.ndarray],
                                cfg: Wav2Vec2Config) -> dict[str, torch.Tensor]:
    """HF ``Wav2Vec2Model`` state dict (numpy values; a pre-training or
    task model's with its ``wav2vec2.`` prefix, whose quantizer, projections
    and head are dropped) -> ``Wav2Vec2Model``'s. Raises KeyError for a
    missing entry and ValueError for one left over, naming it. A checkpoint
    without ``masked_spec_embed`` gets a zero one: extraction never reads it."""
    take = _Leaves(_backbone(sd, "wav2vec2."))
    state: dict[str, torch.Tensor] = {}
    _convert_stem(take, cfg, state)
    for layer in range(cfg.num_hidden_layers):
        src = f"encoder.layers.{layer}"
        for name, hf_name in _HF_WAVLM_LAYER.items():
            if not name.startswith("attention.gru"):
                state[f"layers.{layer}.{name}"] = take(f"{src}.{hf_name}")
    take.check_all_used()
    return state


def w2v_bert_config_from_hf(hf: Mapping, preprocessor: Mapping | None = None) -> W2VBertConfig:
    """``W2VBertConfig`` from an HF ``config.json`` and, where given, its
    ``preprocessor_config.json`` (as dicts). Raises ``ValueError`` for what
    the port does not compute (``W2VBertConfig`` says what)."""
    pp = preprocessor or {}
    fields = {f.name for f in dataclasses.fields(W2VBertConfig)}
    known = {k: v for k, v in hf.items() if k in fields}
    for key in ("num_mel_bins", "stride", "sampling_rate"):
        if key in pp:
            known[key] = pp[key]
    return W2VBertConfig(**known)


# port name under layers.{i} -> HF name under encoder.layers.{i}
_HF_W2V_BERT_LAYER = {
    **{f"{ln}_{p}": f"{hf}.{w}" for ln, hf in (
        ("ffn1_ln", "ffn1_layer_norm"), ("attn_ln", "self_attn_layer_norm"),
        ("ffn2_ln", "ffn2_layer_norm"), ("final_ln", "final_layer_norm"),
        ("conv.ln", "conv_module.layer_norm"), ("conv.dw_ln", "conv_module.depthwise_layer_norm"))
       for p, w in (("s", "weight"), ("b", "bias"))},
    **{f"{ffn}.{p}": f"{ffn}.{hf}" for ffn in ("ffn1", "ffn2") for p, hf in (
        ("w1", "intermediate_dense.weight"), ("b1", "intermediate_dense.bias"),
        ("w2", "output_dense.weight"), ("b2", "output_dense.bias"))},
    **{f"attention.{n}_{p}": f"self_attn.linear_{hf}.{w}" for n, hf in (
        ("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))
       for p, w in (("w", "weight"), ("b", "bias"))},
    "attention.distance_embedding": "self_attn.distance_embedding.weight",
    "conv.dw_w": "conv_module.depthwise_conv.weight",
}


def convert_w2v_bert_state_dict(sd: Mapping[str, np.ndarray],
                                cfg: W2VBertConfig) -> dict[str, torch.Tensor]:
    """HF ``Wav2Vec2BertModel`` state dict (numpy values; a task model's
    with its ``wav2vec2_bert.`` prefix, whose head is dropped) ->
    ``W2VBertModel``'s, the published values unfolded. The pointwise convs'
    [out, in, 1] weights become [out, in]; SpecAugment's
    ``masked_spec_embed`` (training only) is dropped. Raises KeyError for a
    missing entry and ValueError for one left over, naming it."""
    take = _Leaves(_backbone(sd, "wav2vec2_bert."))
    state: dict[str, torch.Tensor] = {
        "feature_projection.ln_scale": take("feature_projection.layer_norm.weight"),
        "feature_projection.ln_bias": take("feature_projection.layer_norm.bias"),
        "feature_projection.weight": take("feature_projection.projection.weight"),
        "feature_projection.bias": take("feature_projection.projection.bias"),
    }
    if "masked_spec_embed" in take.leaves:
        take.array("masked_spec_embed")
    for layer in range(cfg.num_hidden_layers):
        src, dst = f"encoder.layers.{layer}", f"layers.{layer}"
        for name, hf_name in _HF_W2V_BERT_LAYER.items():
            state[f"{dst}.{name}"] = take(f"{src}.{hf_name}")
        for pw in ("pw1", "pw2"):
            state[f"{dst}.conv.{pw}_w"] = take(
                f"{src}.conv_module.pointwise_conv{pw[-1]}.weight").squeeze(-1)
    take.check_all_used()
    return state


def _hf_whisper_layer(name: str, decoder: bool) -> str:
    """The port's name under ``{encoder,decoder}.layers.{i}`` -> HF's:
    attn.q_w -> self_attn.q_proj.weight, xattn.o_b -> encoder_attn.out_proj.bias,
    ffn.fc1_w -> fc1.weight, ln2_s -> (decoder) encoder_attn_layer_norm.weight."""
    leaf = {"w": "weight", "b": "bias", "s": "weight"}
    if name.startswith(("attn.", "xattn.")):
        block, _, key = name.partition(".")
        proj, _, kind = key.partition("_")
        module = {"attn": "self_attn", "xattn": "encoder_attn"}[block]
        return f"{module}.{'out' if proj == 'o' else proj}_proj.{leaf[kind]}"
    if name.startswith("ffn."):
        fc, _, kind = name[len("ffn."):].partition("_")
        return f"{fc}.{leaf[kind]}"
    norm, _, kind = name.partition("_")
    norms = {"ln1": "self_attn_layer_norm", "ln3": "final_layer_norm",
             "ln2": "encoder_attn_layer_norm" if decoder else "final_layer_norm"}
    return f"{norms[norm]}.{leaf[kind]}"


def convert_whisper_state_dict(sd: Mapping[str, np.ndarray],
                               cfg: WhisperConfig) -> dict[str, torch.Tensor]:
    """HF ``WhisperModel`` state dict (numpy values; a
    ``WhisperForConditionalGeneration``'s with its ``model.`` prefix) ->
    ``WhisperModel``'s. Raises KeyError for a missing entry and ValueError
    for one left over, naming it."""
    take = _Leaves(_backbone(sd, "model."))
    top = {"encoder.conv1_w": "encoder.conv1.weight", "encoder.conv1_b": "encoder.conv1.bias",
           "encoder.conv2_w": "encoder.conv2.weight", "encoder.conv2_b": "encoder.conv2.bias",
           "encoder.pos_embed": "encoder.embed_positions.weight",
           "encoder.ln_s": "encoder.layer_norm.weight", "encoder.ln_b": "encoder.layer_norm.bias",
           "decoder.embed_tokens": "decoder.embed_tokens.weight",
           "decoder.pos_embed": "decoder.embed_positions.weight",
           "decoder.ln_s": "decoder.layer_norm.weight", "decoder.ln_b": "decoder.layer_norm.bias"}
    state: dict[str, torch.Tensor] = {}
    for name in WhisperModel(cfg, device="meta").state_dict():
        block, _, rest = name.partition(".")
        if rest.startswith("layers."):
            i, _, leaf = rest[len("layers."):].partition(".")
            state[name] = take(f"{block}.layers.{i}.{_hf_whisper_layer(leaf, block == 'decoder')}")
        else:
            state[name] = take(top[name])
    take.check_all_used()
    return state


def _wavlm_do_normalize(path: str) -> bool:
    """The checkpoint's frontend policy: ``do_normalize`` of its
    ``preprocessor_config.json``; without one, the JAX package's last resort,
    the name (the wavlm-large family normalises), with a warning."""
    pp = os.path.join(path, "preprocessor_config.json")
    if os.path.isfile(pp):
        return bool(_read_json(pp).get("do_normalize", False))
    do_norm = "large" in os.path.basename(os.path.normpath(path)).lower()
    logger.warning("no preprocessor config found; inferring do_normalize=%s from the "
                   "checkpoint name (wavlm-large family normalizes)", do_norm)
    return do_norm


def _model_from_state(model_cls, cfg, state: dict[str, torch.Tensor]) -> Any:
    model = model_cls(cfg)
    model.load_state_dict(state, strict=True)
    return model


def load_wavlm(path: str) -> tuple[WavLMConfig, WavLMModel]:
    """A local HF WavLM checkpoint directory -> (config, float32
    ``WavLMModel`` on the CPU). Any other name raises ``OSError``: this
    package never downloads."""
    path = _local_dir(path)
    cfg = wavlm_config_from_hf(_read_json(os.path.join(path, "config.json")))
    cfg = dataclasses.replace(cfg, do_normalize=_wavlm_do_normalize(path))
    state = convert_wavlm_state_dict(_load_state_dict_from_dir(path), cfg)
    logger.info("converted WavLM %s: %d layers, hidden %d", path, cfg.num_hidden_layers,
                cfg.hidden_size)
    return cfg, _model_from_state(WavLMModel, cfg, state)


def _wav2vec2_do_normalize(path: str, cfg: Wav2Vec2Config) -> bool:
    """``do_normalize`` of the checkpoint's ``preprocessor_config.json``;
    without one, whether the stem is the layer-norm one (XLS-R and the large
    models were trained on normalised waves, the group-norm base models
    not), with a warning."""
    pp = os.path.join(path, "preprocessor_config.json")
    if os.path.isfile(pp):
        return bool(_read_json(pp).get("do_normalize", True))
    do_norm = cfg.feat_extract_norm == "layer"
    logger.warning("no preprocessor config found; inferring do_normalize=%s from the "
                   "stem's norm (%s)", do_norm, cfg.feat_extract_norm)
    return do_norm


def wav2vec2_config(path: str) -> Wav2Vec2Config:
    """The ``Wav2Vec2Config`` of a local HF checkpoint directory, its
    frontend norm included, without reading the weights."""
    path = _local_dir(path)
    cfg = wav2vec2_config_from_hf(_read_json(os.path.join(path, "config.json")))
    return dataclasses.replace(cfg, do_normalize=_wav2vec2_do_normalize(path, cfg))


def load_wav2vec2(path: str) -> tuple[Wav2Vec2Config, Wav2Vec2Model]:
    """A local HF wav2vec 2.0 / XLS-R checkpoint directory -> (config,
    float32 ``Wav2Vec2Model`` on the CPU). Any other name raises
    ``OSError``: this package never downloads."""
    cfg = wav2vec2_config(path)
    state = convert_wav2vec2_state_dict(_load_state_dict_from_dir(path), cfg)
    logger.info("converted wav2vec2 %s: %d layers, hidden %d", path, cfg.num_hidden_layers,
                cfg.hidden_size)
    return cfg, _model_from_state(Wav2Vec2Model, cfg, state)


def w2v_bert_config(path: str) -> W2VBertConfig:
    """The ``W2VBertConfig`` of a local HF checkpoint directory, its
    frontend's sizes included, without reading the weights."""
    path = _local_dir(path)
    pp = os.path.join(path, "preprocessor_config.json")
    return w2v_bert_config_from_hf(_read_json(os.path.join(path, "config.json")),
                                   _read_json(pp) if os.path.isfile(pp) else None)


def load_w2v_bert(path: str) -> tuple[W2VBertConfig, W2VBertModel]:
    """A local HF w2v-BERT checkpoint directory -> (config, float32
    ``W2VBertModel`` on the CPU, unfolded). Any other name raises
    ``OSError``: this package never downloads."""
    cfg = w2v_bert_config(path)
    state = convert_w2v_bert_state_dict(_load_state_dict_from_dir(path), cfg)
    logger.info("converted w2v-BERT %s: %d layers, hidden %d", path, cfg.num_hidden_layers,
                cfg.hidden_size)
    return cfg, _model_from_state(W2VBertModel, cfg, state)


def load_whisper(path: str) -> tuple[WhisperConfig, WhisperModel]:
    """A local HF Whisper checkpoint directory -> (config, float32
    ``WhisperModel`` on the CPU). Any other name raises ``OSError``: this
    package never downloads."""
    path = _local_dir(path)
    cfg = whisper_config_from_hf(_read_json(os.path.join(path, "config.json")))
    state = convert_whisper_state_dict(_load_state_dict_from_dir(path), cfg)
    logger.info("converted Whisper %s: %d enc / %d dec layers, d_model %d", path,
                cfg.encoder_layers, cfg.decoder_layers, cfg.d_model)
    return cfg, _model_from_state(WhisperModel, cfg, state)
