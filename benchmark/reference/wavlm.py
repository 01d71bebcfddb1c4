"""Plain WavLM in float32 PyTorch: the reference that decides ``correct``.

Follows the published model (Chen et al. 2022, "WavLM"; the layout of
microsoft/wavlm-large's ``config.json`` and HF's ``modeling_wavlm.py``) one
clip at a time, so it needs no padding and no masks: the per-clip
zero-mean, unit-variance waveform norm (variance epsilon 1e-7) where the
configuration asks for it; the seven-convolution stem, each convolution
with its bias, a layer norm over channels and GELU (``feat_extract_norm``
"layer"), or a group norm after the first only ("group"); the feature
projection's layer norm and linear map; the grouped positional convolution
with its last frame dropped and GELU, added to its input; the stable pre-LN
layers (WavLM-Large) or post-LN layers, each with gated relative-position
attention, where the bias of the bucketed relative distances is scaled per
query row by the GRU gate of that row's input; and a final layer norm.
Hidden state i is the input of layer i, and the last is the final norm's
output. Each selected state is mean-pooled over the clip's frames.

It takes the weights by the names of the state dict the benchmark made,
works out the relative-position buckets itself (in float32, as HF does),
and imports nothing of the program. Departures: none in the arithmetic;
GELU is the exact (erf) form throughout. Call it under ``no_tf32``.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def no_tf32():
    """Full float32 matrix products and convolutions on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def buckets(L: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """[L, L] bucket of each relative distance (memory - context)."""
    rel = np.arange(L)[None, :] - np.arange(L)[:, None]
    nb = num_buckets // 2
    out = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    exact = nb // 2
    with np.errstate(divide="ignore"):
        large = np.log(np.maximum(rel, 1).astype(np.float32) / np.float32(exact))
    large = large / np.float32(math.log(max_distance / exact)) * np.float32(nb - exact)
    large = np.minimum((exact + large).astype(np.int64), nb - 1)
    return out + np.where(rel < exact, rel, large)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def stem(cfg: dict, W: dict, wave: torch.Tensor) -> torch.Tensor:
    """[T] wave -> [L, C] frames."""
    x = wave[None, None]
    for i, (k, s) in enumerate(zip(cfg["conv_kernel"], cfg["conv_stride"])):
        p = f"feature_encoder.layers.{i}."
        x = F.conv1d(x, W[p + "weight"], W.get(p + "bias"), stride=s)
        if cfg["feat_extract_norm"] == "layer":
            x = layer_norm(x.transpose(1, 2), W[p + "norm_scale"], W[p + "norm_bias"],
                           1e-5).transpose(1, 2)
        elif i == 0:
            x = F.group_norm(x, x.shape[1], W[p + "norm_scale"], W[p + "norm_bias"], 1e-5)
        x = F.gelu(x)
    return x[0].t()


def attention(cfg: dict, W: dict, p: str, x: torch.Tensor, bias: torch.Tensor):
    """Gated relative-position self-attention of [L, D] x; bias [H, L, L]."""
    L, D = x.shape
    H = cfg["num_attention_heads"]
    hd = D // H
    heads = x.view(L, H, hd)
    g = torch.sigmoid((heads @ W[p + "gru_w"].t() + W[p + "gru_b"]).view(L, H, 2, 4).sum(-1))
    gate = g[..., 0] * (g[..., 1] * W[p + "gru_const"] - 1.0) + 2.0  # [L, H]
    q = (x @ W[p + "q_w"].t() + W[p + "q_b"]).view(L, H, hd).transpose(0, 1) * hd ** -0.5
    k = (x @ W[p + "k_w"].t() + W[p + "k_b"]).view(L, H, hd).transpose(0, 1)
    v = (x @ W[p + "v_w"].t() + W[p + "v_b"]).view(L, H, hd).transpose(0, 1)
    scores = q @ k.transpose(1, 2) + gate.t()[:, :, None] * bias
    out = (torch.softmax(scores, dim=-1) @ v).transpose(0, 1).reshape(L, D)
    return out @ W[p + "o_w"].t() + W[p + "o_b"]


def feed_forward(W: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ W[p + "w1"].t() + W[p + "b1"]) @ W[p + "w2"].t() + W[p + "b2"]


def hidden_states(cfg: dict, W: dict, wave: torch.Tensor, time_mask=None,
                  frozen_stem: bool = False) -> list[torch.Tensor]:
    """Every hidden state of one clip: [N + 1] x [L, D]. ``time_mask`` [L]
    (SpecAugment, in training) replaces the masked frames of the feature
    projection's output by ``masked_spec_embed``; ``frozen_stem`` keeps the
    stem out of the gradient."""
    if cfg["do_normalize"]:
        wave = (wave - wave.mean()) / torch.sqrt(wave.var(unbiased=False) + 1e-7)
    with torch.no_grad() if frozen_stem else contextlib.nullcontext():
        feats = stem(cfg, W, wave)
    eps = cfg["layer_norm_eps"]
    x = layer_norm(feats, W["feature_projection.ln_scale"], W["feature_projection.ln_bias"],
                   eps) @ W["feature_projection.weight"].t() + W["feature_projection.bias"]
    if time_mask is not None:
        x = torch.where(time_mask[:, None], W["masked_spec_embed"], x)
    K = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.t()[None], W["pos_conv.weight"], W["pos_conv.bias"], padding=K // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
    if K % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos)[0].t()
    stable = cfg["do_stable_layer_norm"]
    if not stable:
        x = layer_norm(x, W["ln_scale"], W["ln_bias"], eps)
    L = x.shape[0]
    idx = torch.from_numpy(buckets(L, cfg["num_buckets"], cfg["max_bucket_distance"]))
    bias = W["rel_attn_embed"][idx.to(x.device)].permute(2, 0, 1)  # [H, L, L]
    states = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        states.append(x)
        if stable:
            x = x + attention(cfg, W, p + "attention.", layer_norm(
                x, W[p + "ln1_s"], W[p + "ln1_b"], eps), bias)
            x = x + feed_forward(W, p + "feed_forward.", layer_norm(
                x, W[p + "ln2_s"], W[p + "ln2_b"], eps))
        else:
            x = layer_norm(x + attention(cfg, W, p + "attention.", x, bias),
                           W[p + "ln1_s"], W[p + "ln1_b"], eps)
            x = layer_norm(x + feed_forward(W, p + "feed_forward.", x),
                           W[p + "ln2_s"], W[p + "ln2_b"], eps)
    if stable:
        x = layer_norm(x, W["ln_scale"], W["ln_bias"], eps)
    states.append(x)
    return states


@torch.no_grad()
def pooled(cfg: dict, W: dict, wave: torch.Tensor, layers) -> torch.Tensor:
    """[len(layers), D] mean over the clip's frames of the states ``layers``."""
    states = hidden_states(cfg, W, wave)
    return torch.stack([states[i].mean(dim=0) for i in layers])
