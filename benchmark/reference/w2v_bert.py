"""Plain w2v-BERT 2.0 in numpy and float32 PyTorch: the reference that decides
``correct`` for the w2v_bert family.

Follows the published model (the speech encoder of SeamlessM4T,
arXiv:2308.11596, pre-trained as w2v-BERT, arXiv:2108.06209, on Conformer
layers, arXiv:2005.08100; the layout of facebook/w2v-bert-2.0's
``config.json`` and HF's ``modeling_wav2vec2_bert.py`` and
``feature_extraction_seamless_m4t.py``) one clip at a time, so it needs no
padding and no masks:

- the frontend in float64 numpy, written out from its equations: the wave
  times 2^15; 400-sample frames every 160 samples, no centring; each frame's
  mean removed, pre-emphasis 0.97 (the first sample times 0.03), a Povey
  window (the symmetric Hann window to the power 0.85), zero-padded to 512;
  the power of its real FFT; 80 triangular filters on the Kaldi mel scale
  1127 ln(1 + f / 700) over 20-8000 Hz, drawn in mel space, unnormalised;
  floored at 1.1920929e-7; the natural log, rounded to float32; each mel
  bin normalised over the clip's frames (variance with ddof 1, epsilon
  1e-7); frame pairs stacked into rows of 160, an odd last frame dropped;
- the feature projection (a layer norm and a linear map);
- every Conformer layer as HF writes it: x + FFN1(LN(x)) * 0.5, then
  x + attention(LN(x)), then x + conv(x), then LN(x + FFN2(LN(x)) * 0.5),
  the FFNs with swish; attention with biases on q, k, v and the output, and
  the relative-key term as HF's einsum of q with the [L, L, d] embeddings of
  the distances j - i clamped to [-64, 8], added to q k^T and the sum scaled
  by head_dim^-1/2; the convolution module LN, a pointwise conv to twice the
  width, GLU, the causal depthwise conv (left-padded by kernel - 1), LN,
  swish and a pointwise conv, none with a bias.

Hidden state 0 is the projection and state i layer i's output. Each selected
state is mean-pooled over the clip's rows. It takes the weights by the names
of the state dict the benchmark made (the published values: the 1/2 and
q's scale are not folded in) and imports nothing of the program. Departures
from HF: none in the arithmetic (dropout is off in HF's eval mode too).
Call it under ``no_tf32``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.wavlm import layer_norm, no_tf32

__all__ = ["features", "hidden_states", "no_tf32", "pooled"]


def _kaldi_mel_bank(n_bins: int = 257, n_mels: int = 80, f_min: float = 20.0,
                    f_max: float = 8000.0, sr: int = 16000) -> np.ndarray:
    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    centres = np.linspace(mel(f_min), mel(f_max), n_mels + 2)
    bins = mel(sr / ((n_bins - 1) * 2) * np.arange(n_bins))
    bank = np.zeros((n_bins, n_mels))
    for m in range(n_mels):
        lo, mid, hi = centres[m], centres[m + 1], centres[m + 2]
        rising = (bins - lo) / (mid - lo)
        falling = (hi - bins) / (hi - mid)
        bank[:, m] = np.maximum(0.0, np.minimum(rising, falling))
    return bank


def features(wave: np.ndarray, n_mels: int = 80, stride: int = 2) -> np.ndarray:
    """[T] wave in [-1, 1] -> [frames // stride, n_mels * stride] float32."""
    x = np.asarray(wave, np.float64) * 2.0 ** 15
    n = 1 + (len(x) - 400) // 160
    frames = np.lib.stride_tricks.sliding_window_view(x, 400)[::160][:n]
    frames = frames - frames.mean(axis=1, keepdims=True)
    frames = np.concatenate([frames[:, :1] * (1.0 - 0.97),
                             frames[:, 1:] - 0.97 * frames[:, :-1]], axis=1)
    power = np.abs(np.fft.rfft(frames * np.hanning(400) ** 0.85, n=512)) ** 2
    bank = _kaldi_mel_bank(n_mels=n_mels)
    mel = np.log(np.maximum(1.192092955078125e-07, power @ bank)).astype(np.float32)
    mel = (mel - mel.mean(0)) / np.sqrt(mel.var(0, ddof=1) + 1e-7)
    rows = n // stride
    return mel[: rows * stride].reshape(rows, n_mels * stride).astype(np.float32)


def feed_forward(W: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ W[p + "w1"].t() + W[p + "b1"])
    return h @ W[p + "w2"].t() + W[p + "b2"]


def attention(cfg: dict, W: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    """Self-attention of [L, D] x with the clamped relative-key term."""
    L, D = x.shape
    H = cfg["num_attention_heads"]
    hd = D // H
    q = (x @ W[p + "q_w"].t() + W[p + "q_b"]).view(L, H, hd).transpose(0, 1)
    k = (x @ W[p + "k_w"].t() + W[p + "k_b"]).view(L, H, hd).transpose(0, 1)
    v = (x @ W[p + "v_w"].t() + W[p + "v_b"]).view(L, H, hd).transpose(0, 1)
    left, right = cfg["left_max_position_embeddings"], cfg["right_max_position_embeddings"]
    pos = torch.arange(L, device=x.device)
    distance = (pos[None, :] - pos[:, None]).clamp(-left, right) + left
    emb = W[p + "distance_embedding"][distance]  # [L, L, hd]
    scores = (q @ k.transpose(1, 2) + torch.einsum("hld,lrd->hlr", q, emb)) / hd ** 0.5
    out = (torch.softmax(scores, dim=-1) @ v).transpose(0, 1).reshape(L, D)
    return out @ W[p + "o_w"].t() + W[p + "o_b"]


def conv_module(cfg: dict, W: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    eps = cfg["layer_norm_eps"]
    h = layer_norm(x, W[p + "ln_s"], W[p + "ln_b"], eps)
    h = F.glu(h @ W[p + "pw1_w"].t(), dim=-1).t()[None]  # [1, D, L]
    k = W[p + "dw_w"].shape[-1]
    h = F.conv1d(F.pad(h, (k - 1, 0)), W[p + "dw_w"], groups=h.shape[1])[0].t()
    h = F.silu(layer_norm(h, W[p + "dw_ln_s"], W[p + "dw_ln_b"], eps))
    return h @ W[p + "pw2_w"].t()


def hidden_states(cfg: dict, W: dict, feats: torch.Tensor) -> list[torch.Tensor]:
    """Every hidden state of one clip's [L, 160] features: [N + 1] x [L, D]."""
    eps = cfg["layer_norm_eps"]
    x = layer_norm(feats, W["feature_projection.ln_scale"], W["feature_projection.ln_bias"],
                   eps) @ W["feature_projection.weight"].t() + W["feature_projection.bias"]
    states = [x]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        x = x + feed_forward(W, p + "ffn1.",
                             layer_norm(x, W[p + "ffn1_ln_s"], W[p + "ffn1_ln_b"], eps)) * 0.5
        x = x + attention(cfg, W, p + "attention.",
                          layer_norm(x, W[p + "attn_ln_s"], W[p + "attn_ln_b"], eps))
        x = x + conv_module(cfg, W, p + "conv.", x)
        x = x + feed_forward(W, p + "ffn2.",
                             layer_norm(x, W[p + "ffn2_ln_s"], W[p + "ffn2_ln_b"], eps)) * 0.5
        x = layer_norm(x, W[p + "final_ln_s"], W[p + "final_ln_b"], eps)
        states.append(x)
    return states


@torch.no_grad()
def pooled(cfg: dict, W: dict, wave: np.ndarray, layers, device) -> torch.Tensor:
    """[len(layers), D] mean over the clip's rows of the states ``layers``."""
    feats = torch.from_numpy(features(wave, cfg.get("num_mel_bins", 80),
                                      cfg.get("stride", 2))).to(device)
    states = hidden_states(cfg, W, feats)
    return torch.stack([states[i].mean(dim=0) for i in layers])
