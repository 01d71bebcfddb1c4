"""Whisper in PyTorch: the counterpart of ``stutter_tpu/models/whisper.py``.

The surfaces the reference's Whisper extraction touches: the encoder with
every hidden state, and ONE decoder step for token id 0 at position 0 (not
the real start-of-transcript token: a reference quirk kept on purpose).
``nn.Module``s built on an explicit device, one Python loop over the layers
in place of ``lax.scan``, and the encoder's attention core through
``ops.flash_mha.mha_self`` (the hand-written CUDA kernel on the card, its
plain version on the CPU). Public functions keep the JAX package's layouts:
[B, n_mels, 3000] log-mel in, [B, L, D] hidden states out.

Numerics copied from the JAX package:
- layer norms take f32 statistics and cast back; GELU is the tanh form on
  bf16 and the erf form on f32;
- the stem is two convolutions (k3 p1, then k3 s2 p1), each adding its bias
  and applying GELU in the activation dtype; the sinusoidal positions are
  added in f32 before the cast back;
- q is ((x Wq + bq) * head_dim^-0.5) in the activation dtype; k_proj has no
  bias;
- the decoder's cross-attention for its single query takes the K and V
  projections over to the query side (``_cross_attention_1q`` in JAX) and
  keeps its logits and context in f32: the bf16 operands are upcast, so the
  products are exact and the sums f32;
- a single token's self-attention is its own v (a softmax over one key is 1);
- hidden state i is the INPUT of layer i; the final norm applies to the last
  state only.
The activation dtype is the parameters' dtype: f32 for the fidelity preset,
bf16 (the whole parameter set cast, embeddings included) for the fast preset.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stutter_tpu_torch.models.common import gelu, layer_norm, param
from stutter_tpu_torch.ops.flash_mha import mha_self


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    decoder_layers: int = 32
    decoder_attention_heads: int = 20
    ffn_dim: int = 5120
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    vocab_size: int = 51865
    layer_norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @staticmethod
    def large() -> "WhisperConfig":
        return WhisperConfig()

    @staticmethod
    def large_v2() -> "WhisperConfig":
        return WhisperConfig()

    @staticmethod
    def large_v3() -> "WhisperConfig":
        return WhisperConfig(num_mel_bins=128)

    @staticmethod
    def medium() -> "WhisperConfig":
        return WhisperConfig(
            d_model=1024, encoder_layers=24, encoder_attention_heads=16,
            decoder_layers=24, decoder_attention_heads=16, ffn_dim=4096,
        )

    @staticmethod
    def small() -> "WhisperConfig":
        return WhisperConfig(
            d_model=768, encoder_layers=12, encoder_attention_heads=12,
            decoder_layers=12, decoder_attention_heads=12, ffn_dim=3072,
        )

    @staticmethod
    def base() -> "WhisperConfig":
        return WhisperConfig(
            d_model=512, encoder_layers=6, encoder_attention_heads=8,
            decoder_layers=6, decoder_attention_heads=8, ffn_dim=2048,
        )

    @staticmethod
    def tiny_official() -> "WhisperConfig":
        return WhisperConfig(
            d_model=384, encoder_layers=4, encoder_attention_heads=6,
            decoder_layers=4, decoder_attention_heads=6, ffn_dim=1536,
        )

    @staticmethod
    def tiny(d_model: int = 32, layers: int = 2, heads: int = 4) -> "WhisperConfig":
        return WhisperConfig(
            d_model=d_model, encoder_layers=layers, encoder_attention_heads=heads,
            decoder_layers=layers, decoder_attention_heads=heads, ffn_dim=d_model * 4,
            max_source_positions=1500, vocab_size=128,
        )


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal positions, [length, channels] float32 (numpy,
    verbatim from the JAX package)."""
    if channels % 2:
        raise ValueError(f"channels must be even, got {channels}")
    log_timescale_increment = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


class WhisperAttention(nn.Module):
    """One MHA's projections ([out, in] weights; k_proj has no bias) and the
    three ways Whisper uses them."""

    def __init__(self, d_model: int, heads: int, device=None, dtype=torch.float32):
        super().__init__()
        self.heads = heads
        D = d_model
        self.q_w, self.q_b = param((D, D), device, dtype), param((D,), device, dtype)
        self.k_w = param((D, D), device, dtype)
        self.v_w, self.v_b = param((D, D), device, dtype), param((D,), device, dtype)
        self.o_w, self.o_b = param((D, D), device, dtype), param((D,), device, dtype)

    def self_attention(self, x: torch.Tensor, attention_fn) -> torch.Tensor:
        """Non-causal self-attention over all of x [B, L, D] (the encoder's)."""
        B, L, D = x.shape
        H = self.heads
        hd = D // H
        q = (F.linear(x, self.q_w, self.q_b) * hd**-0.5).to(x.dtype)
        k = F.linear(x, self.k_w).to(x.dtype)
        v = F.linear(x, self.v_w, self.v_b).to(x.dtype)

        def heads(t):  # [B, L, D] -> a [B, H, L, hd] view
            return t.view(B, L, H, hd).transpose(1, 2)

        out = attention_fn(heads(q), heads(k), heads(v))
        out = out.transpose(1, 2).reshape(B, L, D)
        return F.linear(out, self.o_w, self.o_b).to(x.dtype)

    def single_token(self, x: torch.Tensor) -> torch.Tensor:
        """Causal self-attention of one token [B, 1, D]: the softmax over its
        only key is 1, so the context is its v exactly."""
        v = F.linear(x, self.v_w, self.v_b).to(x.dtype)
        return F.linear(v, self.o_w, self.o_b).to(x.dtype)

    def cross_one_query(self, x: torch.Tensor, enc: torch.Tensor,
                        enc_f32: torch.Tensor) -> torch.Tensor:
        """Cross-attention of one query x [B, 1, D] over the encoder state enc
        [B, L, D] (enc_f32 is enc upcast, made once per decoder step).

        With one query the projections reassociate exactly:
        softmax((q Wk_h) enc^T) == softmax(q (enc Wk_h)^T) and
        (p enc) Wv_h + bv_h == p (enc Wv_h + bv), so no [L, D] x [D, D]
        product is needed. The head-side products run in f32; the two
        L-wide products take the activation-dtype operands upcast to f32."""
        B, _, D = x.shape
        H = self.heads
        hd = D // H
        q = (F.linear(x.float(), self.q_w.float()) + self.q_b.float()) * hd**-0.5
        qh = q.view(B, H, hd)
        # fold the key projection into the query: qt[b, h, :] = q_h Wk_h^T
        qt = torch.einsum("bhd,hdD->bhD", qh, self.k_w.float().view(H, hd, D))
        logits = torch.matmul(qt.to(enc.dtype).float(), enc_f32.transpose(1, 2))  # [B, H, L]
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.matmul(probs.to(enc.dtype).float(), enc_f32)  # [B, H, D]
        out = torch.einsum("bhD,hdD->bhd", ctx, self.v_w.float().view(H, hd, D))
        out = out + self.v_b.float().view(H, hd)[None]
        out = out.reshape(B, 1, D).to(x.dtype)
        return F.linear(out, self.o_w, self.o_b).to(x.dtype)


class FeedForward(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None, dtype=torch.float32):
        super().__init__()
        D, Fd = cfg.d_model, cfg.ffn_dim
        self.fc1_w, self.fc1_b = param((Fd, D), device, dtype), param((Fd,), device, dtype)
        self.fc2_w, self.fc2_b = param((D, Fd), device, dtype), param((D,), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(F.linear(x, self.fc1_w, self.fc1_b).to(x.dtype))
        return F.linear(h, self.fc2_w, self.fc2_b).to(x.dtype)


def _norms(module: nn.Module, names, D: int, device, dtype) -> None:
    for name in names:
        setattr(module, f"{name}_s", param((D,), device, dtype))
        setattr(module, f"{name}_b", param((D,), device, dtype))


class EncoderLayer(nn.Module):
    """Pre-LN: self-attention, then the FFN."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = cfg.layer_norm_eps
        self.attn = WhisperAttention(cfg.d_model, cfg.encoder_attention_heads, device, dtype)
        self.ffn = FeedForward(cfg, device, dtype)
        _norms(self, ("ln1", "ln2"), cfg.d_model, device, dtype)

    def forward(self, x: torch.Tensor, attention_fn) -> torch.Tensor:
        h = layer_norm(x, self.ln1_s, self.ln1_b, self.eps)
        new = x + self.attn.self_attention(h, attention_fn)
        h = layer_norm(new, self.ln2_s, self.ln2_b, self.eps)
        return (new + self.ffn(h)).to(x.dtype)


class DecoderLayer(nn.Module):
    """Pre-LN: self-attention of the one token, cross-attention over the
    encoder state, then the FFN."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = cfg.layer_norm_eps
        H = cfg.decoder_attention_heads
        self.attn = WhisperAttention(cfg.d_model, H, device, dtype)
        self.xattn = WhisperAttention(cfg.d_model, H, device, dtype)
        self.ffn = FeedForward(cfg, device, dtype)
        _norms(self, ("ln1", "ln2", "ln3"), cfg.d_model, device, dtype)

    def forward(self, x, enc, enc_f32):
        h = layer_norm(x, self.ln1_s, self.ln1_b, self.eps)
        new = x + self.attn.single_token(h)
        h = layer_norm(new, self.ln2_s, self.ln2_b, self.eps)
        new = new + self.xattn.cross_one_query(h, enc, enc_f32)
        h = layer_norm(new, self.ln3_s, self.ln3_b, self.eps)
        return (new + self.ffn(h)).to(x.dtype)


# ---------------------------------------------------------------------------
# Encoder and decoder
# ---------------------------------------------------------------------------


class WhisperEncoder(nn.Module):
    """[B, n_mels, 3000] log-mel -> [B, 1500, D]: the conv stem, sinusoidal
    positions, the pre-LN layers and the final norm."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.conv1_w = param((D, cfg.num_mel_bins, 3), device, dtype)
        self.conv1_b = param((D,), device, dtype)
        self.conv2_w = param((D, D, 3), device, dtype)
        self.conv2_b = param((D,), device, dtype)
        self.pos_embed = param((cfg.max_source_positions, D), device, dtype)
        self.ln_s, self.ln_b = param((D,), device, dtype), param((D,), device, dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.encoder_layers))

    def stem(self, mel: torch.Tensor) -> torch.Tensor:
        """[B, n_mels, 3000] -> [B, 1500, D]: both convolutions with their
        bias and GELU in the activation dtype, the positions added in f32."""
        dtype = self.conv1_w.dtype
        x = gelu(F.conv1d(mel.to(dtype), self.conv1_w, padding=1)
                 + self.conv1_b[None, :, None])
        x = gelu(F.conv1d(x, self.conv2_w, stride=2, padding=1) + self.conv2_b[None, :, None])
        x = x.transpose(1, 2).contiguous()
        return (x.float() + self.pos_embed.float()[None]).to(dtype)

    def forward(self, mel: torch.Tensor,
                reducer: Callable[[int, torch.Tensor], torch.Tensor | None] | None = None,
                attention_fn=None):
        """Returns (last hidden state [B, 1500, D], [reducer(i, h_i) for the
        N + 1 hidden states]); with no reducer, the states themselves.
        ``attention_fn`` replaces the attention core (default ``mha_self``)."""
        attention_fn = attention_fn or mha_self
        reducer = reducer or (lambda i, h: h)
        x = self.stem(mel)
        eps = self.cfg.layer_norm_eps
        collected = []
        for i, layer in enumerate(self.layers):
            collected.append(reducer(i, x))  # layer i's INPUT (HF hidden_states[i])
            x = layer(x, attention_fn)
        x = layer_norm(x, self.ln_s, self.ln_b, eps)
        collected.append(reducer(len(self.layers), x))
        return x, collected


class WhisperDecoder(nn.Module):
    """Token and learned position embeddings, the pre-LN layers, the final norm."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.embed_tokens = param((cfg.vocab_size, D), device, dtype)
        self.pos_embed = param((cfg.max_target_positions, D), device, dtype)
        self.ln_s, self.ln_b = param((D,), device, dtype), param((D,), device, dtype)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.decoder_layers))


def whisper_decoder_step(decoder: WhisperDecoder, encoder_hidden: torch.Tensor,
                         token_id: int = 0):
    """One decoder forward of a single token at position 0 over the encoder
    state [B, L, D]. Returns (last [B, 1, D], hidden states [N+1, B, 1, D])."""
    cfg = decoder.cfg
    dtype = decoder.ln_s.dtype
    B = encoder_hidden.shape[0]
    x = (decoder.embed_tokens[token_id] + decoder.pos_embed[0]).to(dtype)
    x = x.view(1, 1, cfg.d_model).expand(B, 1, cfg.d_model)
    enc = encoder_hidden.to(dtype)
    enc_f32 = enc.float()
    states = []
    for layer in decoder.layers:
        states.append(x)  # layer i's INPUT
        x = layer(x, enc, enc_f32)
    x = layer_norm(x, decoder.ln_s, decoder.ln_b, cfg.layer_norm_eps)
    states.append(x)
    return x, torch.stack(states)


class WhisperModel(nn.Module):
    """The encoder and the decoder. Parameters are created uninitialised on
    ``device``; fill them with ``weights.convert.init_whisper`` or
    ``load_state_dict``."""

    def __init__(self, cfg: WhisperConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.encoder = WhisperEncoder(cfg, device, dtype)
        self.decoder = WhisperDecoder(cfg, device, dtype)

    @torch.inference_mode()
    def forward(self, mel: torch.Tensor, attention_fn=None):
        """mel [B, n_mels, 3000] -> (encoder last [B, 1500, D], encoder states
        [N+1, B, 1500, D], decoder last [B, 1, D], decoder states [N+1, B, 1, D]),
        the decoder run for token id 0 as the reference runs it."""
        enc_last, enc_states = self.encoder(mel, attention_fn=attention_fn)
        dec_last, dec_states = whisper_decoder_step(self.decoder, enc_last, 0)
        return enc_last, torch.stack(enc_states), dec_last, dec_states

    @torch.inference_mode()
    def embed(self, mel: torch.Tensor, encoder_indices, decoder_indices,
              attention_fn=None) -> torch.Tensor:
        """The extraction path: encoder states at ``encoder_indices``, each
        mean-pooled in f32 over all 1500 frames (padding included, as the
        reference pools), then decoder states at ``decoder_indices`` at the
        single token: [len(encoder_indices) + len(decoder_indices), B, D] f32."""
        wanted = set(encoder_indices)

        def pool(i, h):
            return h.float().mean(dim=1) if i in wanted else None

        enc_last, pooled = self.encoder(mel, pool, attention_fn)
        _, dec_states = whisper_decoder_step(self.decoder, enc_last, 0)
        return torch.stack([pooled[i] for i in encoder_indices]
                           + [dec_states[i][:, 0].float() for i in decoder_indices])
