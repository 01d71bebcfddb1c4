"""WavLM and Whisper parameters for the port: from the JAX package's pytree, or seeded.

``wavlm_params_from_numpy`` and ``whisper_params_from_numpy`` map the
parameter pytree of ``stutter_tpu.models.wavlm.init_wavlm_params`` /
``stutter_tpu.models.whisper.init_whisper_params`` (or of the JAX package's
HF converters), given as numpy arrays, onto ``WavLMModel``'s /
``WhisperModel``'s state dict: the stacked leading layer axis is split into
one entry per layer, and dense weights go from JAX's [in, out] to PyTorch's
[out, in]. Every leaf must be used exactly once.

``init_wavlm`` and ``init_whisper`` build a model with a seeded random init
drawn like the JAX package's (normal * fan_in^-0.5 weights, zero biases, unit
norm scales), from a ``torch.Generator`` on the CPU so that the same seed
gives the same weights on every device. Loading HF checkpoints is not in
this package yet.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel, sinusoids

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


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists -> {"a/b/0/c": leaf}; None leaves are absent."""
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix: np.asarray(tree)}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


class _Leaves:
    """The flattened leaves of a pytree, each to be taken exactly once."""

    def __init__(self, tree: Any):
        self.leaves = _flatten(tree)
        self.used: set[str] = set()

    def __call__(self, path: str, transpose: bool = False) -> torch.Tensor:
        if path not in self.leaves:
            raise KeyError(f"parameter tree has no leaf {path!r}")
        self.used.add(path)
        a = self.leaves[path]
        return torch.from_numpy(np.array(a.T if transpose else a, order="C"))

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
        if cfg.feat_extract_norm == "layer" or (cfg.feat_extract_norm == "group" and i == 0):
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
    model = WavLMModel(cfg, device="meta")

    def normal(shape, std):
        return torch.randn(shape, generator=generator) * std

    state: dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        shape, leaf = tuple(p.shape), name.rsplit(".", 1)[-1]
        if leaf in ("norm_scale", "ln_scale", "ln1_s", "ln2_s", "gru_const"):
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
    model = WavLMModel(cfg, device=device)
    model.load_state_dict(state, strict=True)
    return model


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
