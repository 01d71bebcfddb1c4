"""wav2vec 2.0 (XLS-R) in PyTorch: a waveform encoder beside WavLM.

The model of Baevski et al. 2020, "wav2vec 2.0", at the sizes of Babu et al.
2021, "XLS-R" (arXiv:2111.09296, Table 1), laid out as HF's
``Wav2Vec2Model`` and its ``config.json`` name it. It has no counterpart in
the JAX package. Most of it is WavLM's, and runs on WavLM's modules
(``models/wavlm.py``): the seven-convolution stem (``ConvFeatureEncoder``,
with the fused stem kernel of ``ops.wavlm_stem`` wherever its gate passes),
the feature projection, the weight-normed grouped positional convolution and
the GELU feed-forward. What differs is the attention: plain multi-head
self-attention with biases on q, k, v and o, q scaled by head_dim^-0.5, no
relative-position bias and no gate, through ``ops.flash_mha.mha_self``
with each clip's key count (the hand-written kernel on the card, at
head_dim 64 or 120; its plain version on the CPU).

The layers are HF's ``Wav2Vec2EncoderLayerStableLayerNorm`` (pre-LN, a
final norm after the last layer: XLS-R and the large models; the post-LN
base models are not ported, ``wav2vec2_config_from_hf`` refuses them).
Padded frames are zeroed
before the positional convolution and keys past each clip's frames are
masked (HF's ``hidden_states[~mask] = 0`` and its additive mask), so a
padded batch equals per-clip runs. Numerics are WavLM's in this package:
f32 norm statistics cast back to the activation dtype, GELU tanh on bf16 and
erf on f32, the positional conv's bias and GELU in f32, q scaled in the
activation dtype, keys masked with -1e9. Hidden state i is the input of
layer i; the last is the final norm's output.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from stutter_tpu_torch.models.common import add_layer_norm, layer_norm, param
from stutter_tpu_torch.models.wavlm import (
    ConvFeatureEncoder,
    FeatureProjection,
    FeedForward,
    PosConvEmbedding,
    WavLMConfig,
    wavlm_feature_lengths,
)
from stutter_tpu_torch.ops.flash_mha import mha_self
from stutter_tpu_torch.ops.pooling import masked_mean_pool
from stutter_tpu_torch.ops.quant import linear


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """HF ``Wav2Vec2Config``'s fields that the forward reads, by their
    ``config.json`` names; the defaults are XLS-R 2B's."""

    hidden_size: int = 1920
    num_hidden_layers: int = 48
    num_attention_heads: int = 16
    intermediate_size: int = 7680
    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" (XLS-R, large) | "group" (base)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    # frontend policy (HF preprocessor_config.json)
    do_normalize: bool = True

    head_dim = WavLMConfig.head_dim
    stem_geometry = WavLMConfig.stem_geometry

    @staticmethod
    def xls_r_2b() -> "Wav2Vec2Config":
        """facebook/wav2vec2-xls-r-2b: 48 layers of 1920, 16 heads of 120."""
        return Wav2Vec2Config()

    @staticmethod
    def xls_r_1b() -> "Wav2Vec2Config":
        """facebook/wav2vec2-xls-r-1b: 48 layers of 1280, 16 heads of 80."""
        return Wav2Vec2Config(hidden_size=1280, intermediate_size=5120)

    @staticmethod
    def xls_r_300m() -> "Wav2Vec2Config":
        """facebook/wav2vec2-xls-r-300m: 24 layers of 1024, 16 heads of 64."""
        return Wav2Vec2Config(hidden_size=1024, num_hidden_layers=24, intermediate_size=4096)

    @staticmethod
    def tiny(hidden_size: int = 32, layers: int = 2, heads: int = 4) -> "Wav2Vec2Config":
        """Small config for the CPU tests (XLS-R's code paths, a 20x stem;
        16 positional-conv groups, as WavLM's tiny: PyTorch's CPU bf16
        grouped conv1d is wrong at 8 channels a group)."""
        return Wav2Vec2Config(
            hidden_size=hidden_size,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            intermediate_size=hidden_size * 4,
            conv_dim=(16, 16, 16),
            conv_stride=(5, 2, 2),
            conv_kernel=(10, 3, 3),
            num_conv_pos_embeddings=16,
        )


class SelfAttention(nn.Module):
    """Plain multi-head self-attention; weights are [out, in] (the names of
    WavLM's attention, so that turbo's ``WAVLM_QUANT_KEYS`` apply)."""

    def __init__(self, cfg: Wav2Vec2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.head_dim
        D = cfg.hidden_size
        for name in ("q", "k", "v", "o"):
            setattr(self, f"{name}_w", param((D, D), device, dtype))
            setattr(self, f"{name}_b", param((D,), device, dtype))

    def forward(self, x: torch.Tensor, kv_valid: torch.Tensor | None) -> torch.Tensor:
        B, L, D = x.shape
        H, hd = self.heads, self.head_dim

        def heads(t):  # [B, L, D] -> a [B, H, L, hd] view
            return t.view(B, L, H, hd).transpose(1, 2)

        q = linear(x, self.q_w, self.q_b).to(x.dtype) * hd**-0.5
        k = linear(x, self.k_w, self.k_b).to(x.dtype)
        v = linear(x, self.v_w, self.v_b).to(x.dtype)
        out = mha_self(heads(q), heads(k), heads(v), kv_valid)
        return linear(out.transpose(1, 2).reshape(B, L, D), self.o_w, self.o_b).to(x.dtype)


class EncoderLayer(nn.Module):
    """Pre-LN encoder layer: x + attention(LN(x)), then x + FFN(LN(x))."""

    def __init__(self, cfg: Wav2Vec2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = cfg.layer_norm_eps
        self.attention = SelfAttention(cfg, device, dtype)
        self.feed_forward = FeedForward(cfg, device, dtype)
        D = cfg.hidden_size
        self.ln1_s, self.ln1_b = param((D,), device, dtype), param((D,), device, dtype)
        self.ln2_s, self.ln2_b = param((D,), device, dtype), param((D,), device, dtype)

    def forward(self, x: torch.Tensor, kv_valid: torch.Tensor | None) -> torch.Tensor:
        eps = self.eps
        x, ff_in = add_layer_norm(
            x, self.attention(layer_norm(x, self.ln1_s, self.ln1_b, eps), kv_valid),
            self.ln2_s, self.ln2_b, eps)
        return (x + self.feed_forward(ff_in)).to(x.dtype)


class Wav2Vec2Model(nn.Module):
    """wav2vec 2.0: stem, feature projection, positional conv and the layers.

    ``forward`` returns every hidden state (for tests); ``encode`` the masked
    mean-pool of the selected states, pooled as the loop runs (the
    extraction path); both run under ``inference_mode``. Parameters are
    created uninitialised on ``device``; fill them with
    ``weights.convert.load_wav2vec2`` or ``load_state_dict``.
    """

    def __init__(self, cfg: Wav2Vec2Config, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.feature_encoder = ConvFeatureEncoder(cfg, device, dtype)
        self.feature_projection = FeatureProjection(cfg, device, dtype)
        self.pos_conv = PosConvEmbedding(cfg, device, dtype)
        self.ln_scale = param((D,), device, dtype)
        self.ln_bias = param((D,), device, dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device, dtype) for _ in range(cfg.num_hidden_layers))
        # SpecAugment's mask embedding: training only, kept so that an HF
        # checkpoint converts without loss
        self.masked_spec_embed = param((D,), device, dtype)

    def _run(self, waveform, sample_lengths, collect):
        cfg = self.cfg
        feats = self.feature_encoder.fused(waveform, sample_lengths)
        if feats is None:
            feats = self.feature_encoder(waveform, sample_lengths)
        hidden = self.feature_projection(feats)
        B, L, _ = hidden.shape
        kv_valid = None
        if sample_lengths is not None:
            frame_lengths = wavlm_feature_lengths(cfg, sample_lengths)
            frame_mask = torch.arange(L, device=hidden.device)[None, :] < frame_lengths[:, None]
            hidden = hidden * frame_mask[:, :, None].to(hidden.dtype)
            kv_valid = frame_lengths.to(torch.int32).contiguous()
        else:
            frame_lengths = torch.full((B,), L, dtype=torch.long, device=hidden.device)
        hidden = self.pos_conv(hidden)
        collected = []
        for i, layer in enumerate(self.layers):
            collected.append(collect(i, hidden, frame_lengths))  # layer i's INPUT
            hidden = layer(hidden, kv_valid).to(hidden.dtype)
        hidden = layer_norm(hidden, self.ln_scale, self.ln_bias, cfg.layer_norm_eps)
        collected.append(collect(len(self.layers), hidden, frame_lengths))
        return hidden, collected, frame_lengths

    @torch.inference_mode()
    def forward(self, waveform, sample_lengths=None):
        """waveform [B, T] f32 (frontend-normalised); sample_lengths [B] true
        sample counts. Returns (last [B, L, D], hidden states [N+1, B, L, D],
        frame lengths [B]). The stem takes the fused kernel where
        ``ConvFeatureEncoder.fused`` gives its frames."""
        last, states, frame_lengths = self._run(waveform, sample_lengths, lambda i, h, fl: h)
        return last, torch.stack(states), frame_lengths

    @torch.inference_mode()
    def encode(self, waveform, layer_indices, sample_lengths=None, attention_fn=None):
        """Masked mean-pooled hidden states at ``layer_indices``:
        [len(layer_indices), B, D] f32. ``attention_fn`` is ``WavLMModel.encode``'s
        hook for its long buckets, so that ``WavLMExtractor`` drives both
        models; this model has one attention and takes None alone."""
        if attention_fn is not None:
            raise ValueError("wav2vec2 has no attention hook; attention_fn must be None")
        wanted = set(layer_indices)

        def collect(i, h, frame_lengths):
            return masked_mean_pool(h, frame_lengths) if i in wanted else None

        _, pooled, _ = self._run(waveform, sample_lengths, collect)
        return torch.stack([pooled[i] for i in layer_indices])
