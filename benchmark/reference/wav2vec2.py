"""Plain wav2vec 2.0 (XLS-R) in float32 PyTorch: the reference that decides
``correct`` for the wav2vec2 family.

Follows the published model (Baevski et al. 2020, "wav2vec 2.0"; Babu et al.
2021, "XLS-R", Table 1; the layout of facebook/wav2vec2-xls-r-2b's
``config.json`` and HF's ``modeling_wav2vec2.py``) one clip at a time, so it
needs no padding and no masks: the per-clip zero-mean, unit-variance
waveform norm (variance epsilon 1e-7) where the configuration asks for it;
the seven-convolution stem, each convolution with its bias, a layer norm
over channels and GELU (``Wav2Vec2LayerNormConvLayer``; WavLM's stem, so
``reference/wavlm.py``'s ``stem`` computes it); the feature projection's
layer norm and linear map; the grouped positional convolution with its last
frame dropped and GELU, added to its input; then
``Wav2Vec2EncoderLayerStableLayerNorm`` (x + attention(LN(x)), then
x + FFN(LN(x))) for every layer and a final layer norm
(``Wav2Vec2EncoderStableLayerNorm``: XLS-R's pre-LN layers). Attention is plain multi-head attention with biases on q, k, v and the
output, the scores (q k^T) scaled by head_dim^-0.5 as HF's
``eager_attention_forward`` scales them. Hidden state i is the input of
layer i, and the last is the final norm's output. Each selected state is
mean-pooled over the clip's frames.

It takes the weights by the names of the state dict the benchmark made and
imports nothing of the program. Departures from HF's module: none in the
arithmetic (dropout and SpecAugment are off in HF's eval mode too); GELU is
the exact (erf) form throughout; the positional convolution's weight norm
is taken as already folded into one weight, as the benchmark's weights
come. Call it under ``no_tf32``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.wavlm import feed_forward, layer_norm, no_tf32, stem

__all__ = ["hidden_states", "no_tf32", "pooled"]


def attention(cfg: dict, W: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    """Multi-head self-attention of [L, D] x."""
    L, D = x.shape
    H = cfg["num_attention_heads"]
    hd = D // H
    q = (x @ W[p + "q_w"].t() + W[p + "q_b"]).view(L, H, hd).transpose(0, 1)
    k = (x @ W[p + "k_w"].t() + W[p + "k_b"]).view(L, H, hd).transpose(0, 1)
    v = (x @ W[p + "v_w"].t() + W[p + "v_b"]).view(L, H, hd).transpose(0, 1)
    scores = (q @ k.transpose(1, 2)) * hd ** -0.5
    out = (torch.softmax(scores, dim=-1) @ v).transpose(0, 1).reshape(L, D)
    return out @ W[p + "o_w"].t() + W[p + "o_b"]


def hidden_states(cfg: dict, W: dict, wave: torch.Tensor) -> list[torch.Tensor]:
    """Every hidden state of one clip: [N + 1] x [L, D]."""
    if cfg["do_normalize"]:
        wave = (wave - wave.mean()) / torch.sqrt(wave.var(unbiased=False) + 1e-7)
    feats = stem(cfg, W, wave)
    eps = cfg["layer_norm_eps"]
    x = layer_norm(feats, W["feature_projection.ln_scale"], W["feature_projection.ln_bias"],
                   eps) @ W["feature_projection.weight"].t() + W["feature_projection.bias"]
    K = cfg["num_conv_pos_embeddings"]
    pos = F.conv1d(x.t()[None], W["pos_conv.weight"], W["pos_conv.bias"], padding=K // 2,
                   groups=cfg["num_conv_pos_embedding_groups"])
    if K % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos)[0].t()
    states = []
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        states.append(x)
        x = x + attention(cfg, W, p + "attention.",
                          layer_norm(x, W[p + "ln1_s"], W[p + "ln1_b"], eps))
        x = x + feed_forward(W, p + "feed_forward.",
                             layer_norm(x, W[p + "ln2_s"], W[p + "ln2_b"], eps))
    x = layer_norm(x, W["ln_scale"], W["ln_bias"], eps)
    states.append(x)
    return states


@torch.no_grad()
def pooled(cfg: dict, W: dict, wave: torch.Tensor, layers) -> torch.Tensor:
    """[len(layers), D] mean over the clip's frames of the states ``layers``."""
    states = hidden_states(cfg, W, wave)
    return torch.stack([states[i].mean(dim=0) for i in layers])
