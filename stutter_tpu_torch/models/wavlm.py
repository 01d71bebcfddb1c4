"""WavLM in PyTorch: the counterpart of ``stutter_tpu/models/wavlm.py``.

The same model and the same numerics as the JAX package, in PyTorch's idiom:
``nn.Module``s built on an explicit device, one Python loop over the layers
in place of ``lax.scan``, and the attention core through
``ops.wavlm_attention.gated_relpos_attention`` (the hand-written CUDA kernel
on the card, its plain version on the CPU). Public functions keep the JAX
package's layouts ([B, L, C] frames and hidden states) so that the two
packages compare like with like; inside, the stem runs PyTorch's [B, C, T].
``forward``/``encode`` run the stem through the fused kernel of
``ops.wavlm_stem`` wherever ``ConvFeatureEncoder.fused``'s gate passes.
``PosConvEmbedding`` returns hidden plus the positional
embedding, through ``ops.pos_conv``'s kernel where its gate passes (bf16 on
the card, no autograd). The projections go through ``ops.quant.linear``, which
takes the turbo presets' int8 weights, or with ``int8_forward`` set on a
layer's modules (fine-tuning) ``qdot_ste``. ``pooled_states`` takes the JAX
package's remat policies through ``torch.utils.checkpoint``'s selective
checkpointing (``save_only``, ``SaveAllButAttention``). ``materialized_bias_attention`` is the
JAX package's escape hatch for the long buckets (``wavlm.py:462-469`` there,
set by ``STUTTER_TPU_LONG_ATTENTION_FLASH``): an ``attention_fn`` for
``encode`` that builds the [B, H, L, L] bias and runs ``flash_mha_bias``.

Numerics copied from the JAX package:
- layer norms take f32 statistics and cast back to the activation dtype;
- GELU is the tanh form on bf16 and the erf form on f32;
- a stem conv's bias is added in the activation dtype after the conv; the
  stem's norm statistics use valid frames only and each stage re-zeroes its
  padded frames, so a padded batch equals per-clip runs;
- the positional conv adds its bias in f32, drops its last frame (SamePad,
  even kernel), applies GELU in f32 and casts back, then is added to hidden;
- q is scaled by head_dim^-0.5 in the activation dtype;
- the key mask is additive -1e9 (not -inf), so padded query rows stay finite;
- hidden state i is the INPUT of layer i; the pre-LN model's final norm
  applies to the last state only.
The activation dtype is the parameters' dtype: f32 for the fidelity preset,
bf16 (the whole parameter set cast, norms included) for the fast preset.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from stutter_tpu_torch.models.common import add_layer_norm, gelu, layer_norm, param
from stutter_tpu_torch.ops.flash_mha import flash_mha_bias, flash_mha_bias_reference
from stutter_tpu_torch.ops.pooling import masked_mean_pool
from stutter_tpu_torch.ops.pos_conv import (
    kernel_applies,
    pack_pos_conv_weights,
    pos_conv_residual,
)
from stutter_tpu_torch.ops.quant import linear
from stutter_tpu_torch.ops.wavlm_attention import (
    gated_relpos_attention,
    gated_relpos_attention_diff,
)
from stutter_tpu_torch.ops.wavlm_stem import (
    fused_stem_applicable,
    fused_stem_supported,
    pack_stem_weights,
    wavlm_fused_stem,
)
from stutter_tpu_torch.parallel.collectives import copy_to_model

REMAT_MODES = (None, "layer", "layer_dots", "layer_probs", "nothing", "dots")
# The products the "dots" policies keep: every GEMM under "layer_dots" (JAX's
# dots_saveable), those without batch dimensions under "dots"
# (dots_with_no_batch_dims_saveable). The int8 products of int8_forward count.
_aten = torch.ops.aten
UNBATCHED_GEMMS = (_aten.mm.default, _aten.addmm.default, _aten._int_mm.default)
GEMMS = (*UNBATCHED_GEMMS, _aten.bmm.default)


class SaveAllButAttention:
    """``layer_probs``' policy: inside a layer's checkpoint every operation's
    output is kept except the attention core's, which the backward recomputes
    (JAX saves everything but the [B, H, L, L] chain). The core is a
    ``GatedRelPosAttentionFn``, whose own residuals (q, k, v, the output and
    the row statistics; never the [B, H, L, L] chain) stand in for JAX's
    probabilities: the core's forward runs again in the backward, on the card
    a launch of the forward kernel."""

    def __init__(self, attention_fn):
        self.attention_fn = attention_fn
        self.inside = False

    def attention(self, *args):
        self.inside = True
        try:
            return self.attention_fn(*args)
        finally:
            self.inside = False

    def policy(self, ctx, func, *args, **kwargs):
        return CheckpointPolicy.PREFER_RECOMPUTE if self.inside else CheckpointPolicy.MUST_SAVE


def save_only(ops):
    """A checkpoint ``context_fn`` that keeps the outputs of ``ops`` and
    recomputes everything else. An opaque kernel (a ctypes call inside an
    autograd Function) is not an aten product, so it is recomputed."""
    return functools.partial(create_selective_checkpoint_contexts, list(ops))
LONG_ATTENTION_MIN_L = 1008  # the JAX package's STUTTER_TPU_LONG_ATTENTION_MIN_L default


def materialized_bias_attention(long_min_l: int = LONG_ATTENTION_MIN_L):
    """The escape hatch as an attention function with the signature of
    ``gated_relpos_attention``. Where the JAX gate passes (bf16 activations,
    L >= ``long_min_l``, head_dim >= 64) it builds
    ab = gate * bias + key mask in f32, [B, H, L, L], and runs
    ``flash_mha_bias`` on the card or its plain version on the CPU; every
    other call goes to ``gated_relpos_attention``."""

    def attention(q, k, v, position_bias, gate, key_mask_bias):
        B, H, L, hd = q.shape
        if q.dtype != torch.bfloat16 or L < long_min_l or hd < 64:
            return gated_relpos_attention(q, k, v, position_bias, gate, key_mask_bias)
        ab = (gate[..., None] * position_bias[None]).add_(key_mask_bias[:, None, None, :])
        if q.device.type == "cpu":
            return flash_mha_bias_reference(q, k, v, ab)
        return flash_mha_bias(q, k, v, ab)

    return attention


@dataclasses.dataclass(frozen=True)
class WavLMConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_stride: tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    feat_extract_norm: str = "group"  # "group" (base) | "layer" (large)
    do_stable_layer_norm: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    num_buckets: int = 320
    max_bucket_distance: int = 800
    layer_norm_eps: float = 1e-5
    # frontend policy (HF preprocessor_config.json per checkpoint)
    do_normalize: bool = False
    # SpecAugment (training only)
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def stem_geometry(self) -> tuple[int, int]:
        """(receptive_field, stride) of the conv stem in samples (400, 320
        for the standard 7-layer stem), used for frame-aligned bucketing."""
        k_eff, s_eff = 1, 1
        for k, s in zip(self.conv_kernel, self.conv_stride):
            k_eff += (k - 1) * s_eff
            s_eff *= s
        return k_eff, s_eff

    @staticmethod
    def base() -> "WavLMConfig":
        return WavLMConfig()

    @staticmethod
    def base_plus() -> "WavLMConfig":
        return WavLMConfig()

    @staticmethod
    def large() -> "WavLMConfig":
        return WavLMConfig(
            hidden_size=1024,
            num_hidden_layers=24,
            num_attention_heads=16,
            intermediate_size=4096,
            conv_bias=True,
            feat_extract_norm="layer",
            do_stable_layer_norm=True,
            do_normalize=True,
        )

    @staticmethod
    def tiny(hidden_size: int = 32, layers: int = 2, heads: int = 4) -> "WavLMConfig":
        """Small config for fast numerics tests (same code paths as base)."""
        return WavLMConfig(
            hidden_size=hidden_size,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            intermediate_size=hidden_size * 4,
            conv_dim=(16, 16, 16),
            conv_stride=(5, 2, 2),
            conv_kernel=(10, 3, 3),
        )


# ---------------------------------------------------------------------------
# Relative position buckets: numpy, verbatim from the JAX package. The float32
# np.log decides bucket boundaries; a torch.log could flip one.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def relative_position_buckets(seq_len: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """[L, L] int32 bucket index matrix (compile-time constant per length)."""
    context = np.arange(seq_len, dtype=np.int64)[:, None]
    memory = np.arange(seq_len, dtype=np.int64)[None, :]
    rel = memory - context

    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel_abs = np.abs(rel)
    max_exact = nb // 2
    is_small = rel_abs < max_exact
    with np.errstate(divide="ignore"):
        rel_large = np.log(np.maximum(rel_abs, 1).astype(np.float32) / max_exact)
    rel_large = rel_large / math.log(max_distance / max_exact) * (nb - max_exact)
    rel_large = (max_exact + rel_large).astype(np.int64)
    rel_large = np.minimum(rel_large, nb - 1)
    buckets += np.where(is_small, rel_abs, rel_large)
    return buckets.astype(np.int32)


def wavlm_feature_lengths(cfg: WavLMConfig, input_lengths):
    """Conv output length chain; takes ints, numpy arrays or tensors."""
    lengths = input_lengths
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        lengths = (lengths - k) // s + 1
    return lengths


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


class _ConvLayer(nn.Module):
    def __init__(self, c_in, c_out, kernel, bias, norm, device, dtype):
        super().__init__()
        self.weight = param((c_out, c_in, kernel), device, dtype)
        self.bias = param((c_out,), device, dtype) if bias else None
        self.norm_scale = param((c_out,), device, dtype) if norm else None
        self.norm_bias = param((c_out,), device, dtype) if norm else None


class ConvFeatureEncoder(nn.Module):
    """Raw wave [B, T] -> frames [B, L, conv_dim[-1]] at ~49 Hz.

    ``feat_extract_norm == "group"``: a per-channel norm over time after the
    first conv only, its statistics over valid frames. ``"layer"``: a norm
    over channels after every conv."""

    def __init__(self, cfg: WavLMConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        layers, c_in = [], 1
        for i, c_out in enumerate(cfg.conv_dim):
            norm = cfg.feat_extract_norm == "layer" or (
                cfg.feat_extract_norm == "group" and i == 0)
            layers.append(_ConvLayer(c_in, c_out, cfg.conv_kernel[i], cfg.conv_bias,
                                     norm, device, dtype))
            c_in = c_out
        self.layers = nn.ModuleList(layers)
        self._packed = None  # (signature of the weights, fused stem pack)

    def packed(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The weights as ``ops.wavlm_stem.wavlm_fused_stem`` reads them,
        packed once and kept until a weight changes (a cast, a move, a load)."""
        tensors = [t for layer in self.layers for t in (
            layer.weight, layer.bias, layer.norm_scale, layer.norm_bias) if t is not None]
        signature = tuple((t.data_ptr(), t._version, t.dtype, t.device) for t in tensors)
        if self._packed is None or self._packed[0] != signature:
            self._packed = (signature, pack_stem_weights(self.layers))
        return self._packed[1]

    def fused(self, waveform: torch.Tensor,
              sample_lengths: torch.Tensor | None = None) -> torch.Tensor | None:
        """The frames of ``ops.wavlm_stem.wavlm_fused_stem`` where it applies
        exactly (bf16 weights and ``fused_stem_applicable``) and can run
        (``fused_stem_supported``), zeroed past each clip's frames; None
        elsewhere, where the caller runs the plain stem.

        ``forward`` and ``encode`` of ``WavLMModel`` and ``Wav2Vec2Model``,
        the inference passes (under ``inference_mode``), take these frames
        wherever this gate passes. The differentiable
        ``WavLMModel.pooled_states`` never calls it, with or without
        ``stop_stem_gradient`` and under ``no_grad`` too: the kernel has no
        backward, so fine-tuning's stem stays on the plain path."""
        cfg = self.cfg
        if not (self.layers[0].weight.dtype == torch.bfloat16
                and fused_stem_applicable(cfg, waveform.shape[1], self.layers)
                and fused_stem_supported(cfg, waveform.device)):
            return None
        feats = wavlm_fused_stem(waveform, *self.packed())
        if sample_lengths is not None:
            # the kernel's frames are unmasked; for the per-frame layer-norm
            # stem, end-masking equals the per-layer masking
            fl = wavlm_feature_lengths(cfg, sample_lengths)
            feats = feats * (torch.arange(feats.shape[1], device=feats.device)[None, :]
                             < fl[:, None])[:, :, None].to(feats.dtype)
        return feats

    def forward(self, waveform: torch.Tensor, sample_lengths: torch.Tensor | None = None,
                ) -> torch.Tensor:
        cfg = self.cfg
        dtype = self.layers[0].weight.dtype
        x = waveform[:, None, :].to(dtype)  # [B, 1, T]
        lengths = sample_lengths
        for i, layer in enumerate(self.layers):
            x = F.conv1d(x, layer.weight, stride=cfg.conv_stride[i])
            if layer.bias is not None:
                x = x + layer.bias[None, :, None]
            mask = None
            if lengths is not None:
                lengths = (lengths - cfg.conv_kernel[i]) // cfg.conv_stride[i] + 1
                mask = (torch.arange(x.shape[2], device=x.device)[None, :]
                        < lengths[:, None])[:, None, :]
            if cfg.feat_extract_norm == "group" and i == 0:
                xf = x.float()
                if mask is None:
                    mean = xf.mean(dim=2, keepdim=True)
                    var = (xf - mean).square().mean(dim=2, keepdim=True)
                else:
                    m = mask.float()
                    n = torch.clamp(m.sum(dim=2, keepdim=True), min=1.0)
                    mean = (xf * m).sum(dim=2, keepdim=True) / n
                    var = ((xf - mean) * m).square().sum(dim=2, keepdim=True) / n
                xf = (xf - mean) * torch.rsqrt(var + 1e-5)
                x = (xf * layer.norm_scale[None, :, None]
                     + layer.norm_bias[None, :, None]).to(x.dtype)
            elif cfg.feat_extract_norm == "layer":
                x = layer_norm(x, layer.norm_scale, layer.norm_bias, 1e-5, dim=1)
            x = gelu(x)
            if mask is not None:
                x = x * mask.to(x.dtype)
        return x.transpose(1, 2)  # [B, L, C]


class FeatureProjection(nn.Module):
    """LN over the stem's channels, then Linear(conv_dim[-1] -> hidden)."""

    def __init__(self, cfg: WavLMConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = cfg.layer_norm_eps
        c = cfg.conv_dim[-1]
        self.ln_scale = param((c,), device, dtype)
        self.ln_bias = param((c,), device, dtype)
        self.weight = param((cfg.hidden_size, c), device, dtype)
        self.bias = param((cfg.hidden_size,), device, dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        # the plain stem's frames are a [B, C, T] tensor seen as [B, T, C]:
        # rows of their own let the norm take its kernel (4 bytes an
        # element, where the plain norm moves ~68)
        feats = layer_norm(feats.contiguous(), self.ln_scale, self.ln_bias, self.eps)
        return F.linear(feats, self.weight, self.bias).to(feats.dtype)


class PosConvEmbedding(nn.Module):
    """Grouped conv positional embedding with SamePad, added to its input:
    x -> x + pos_conv(x). The weight norm is folded into the plain weight, as
    in the JAX package.

    Where ``ops.pos_conv.kernel_applies`` (bf16 on the card, 128 taps, 64 or
    120 channels a group, no autograd) the whole of it is one call of the
    hand-written kernel (``ops.pos_conv.pos_conv_residual``), on the weight
    packed for the call: a copy freed after it (16.8 MB at WavLM-Large, 59 MB
    at XLS-R 2B), where a cached pack would raise the memory peak by its
    size. Elsewhere (the CPU, f32, the fine-tuning forward) ``plain`` runs it
    in PyTorch."""

    def __init__(self, cfg: WavLMConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.kernel = cfg.num_conv_pos_embeddings
        self.groups = cfg.num_conv_pos_embedding_groups
        D = cfg.hidden_size
        self.weight = param((D, D // self.groups, self.kernel), device, dtype)
        self.bias = param((D,), device, dtype)

    def plain(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, D]
        y = F.conv1d(x.transpose(1, 2), self.weight, padding=self.kernel // 2,
                     groups=self.groups).float()
        y = y + self.bias.float()[None, :, None]
        if self.kernel % 2 == 0:  # SamePad removes the trailing element
            y = y[:, :, :-1]
        return x + gelu(y).to(x.dtype).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, L, D]
        if kernel_applies(x, self.weight, self.bias, self.kernel, self.groups):
            return pos_conv_residual(x, pack_pos_conv_weights(self.weight), self.bias.float(),
                                     self.groups)
        return self.plain(x)


class GatedRelPosAttention(nn.Module):
    """One gated relative-position-bias MHA. Weights are [out, in]; the GRU
    gate projects each head's input to 8 values summed 2x4.

    Under tensor parallelism (``parallel.sharding.shard_wavlm``) the module
    holds ``heads`` heads from ``head_offset`` on: q, k and v their rows, o
    their columns, and ``tp_group`` is the model group. The gate weights and
    ``gru_const`` stay whole: the rank gates its heads from their columns of
    the layer input and their entries of ``gru_const``."""

    def __init__(self, cfg: WavLMConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.head_dim
        self.head_offset = 0
        self.tp_group = None
        D = cfg.hidden_size
        for name in ("q", "k", "v", "o"):
            setattr(self, f"{name}_w", param((D, D), device, dtype))
            setattr(self, f"{name}_b", param((D,), device, dtype))
        self.gru_w = param((8, self.head_dim), device, dtype)
        self.gru_b = param((8,), device, dtype)
        self.gru_const = param((self.heads,), device, dtype)
        self.int8_forward = False  # q, k, v, o through qdot_ste (fine-tuning)

    def forward(self, x, position_bias, key_mask_bias, attention_fn):
        B, L, D = x.shape
        H, hd, h0, group = self.heads, self.head_dim, self.head_offset, self.tp_group
        x = copy_to_model(x, group)
        gru_w, gru_b, gru_const = (copy_to_model(t, group)
                                   for t in (self.gru_w, self.gru_b, self.gru_const))
        # gate from this rank's heads' raw inputs, projected in [B, L, H, hd] layout
        proj = F.linear(x.view(B, L, D // hd, hd)[:, :, h0:h0 + H], gru_w, gru_b)
        proj = proj.view(B, L, H, 2, 4).sum(-1)
        gates = torch.sigmoid(proj.float().permute(0, 2, 1, 3))
        gate_a, gate_b = gates[..., 0], gates[..., 1]  # [B, H, L]
        const = gru_const[h0:h0 + H].float().view(1, H, 1)
        gate = (gate_a * (gate_b * const - 1.0) + 2.0).contiguous()

        def heads(t):  # [B, L, D] -> a [B, H, L, hd] view
            return t.view(B, L, H, hd).transpose(1, 2)

        ste = self.int8_forward
        q = linear(x, self.q_w, self.q_b, ste=ste).to(x.dtype) * hd**-0.5
        k = linear(x, self.k_w, self.k_b, ste=ste).to(x.dtype)
        v = linear(x, self.v_w, self.v_b, ste=ste).to(x.dtype)
        out = attention_fn(heads(q), heads(k), heads(v), position_bias, gate,
                           key_mask_bias)
        out = out.transpose(1, 2).reshape(B, L, H * hd)
        return linear(out, self.o_w, self.o_b, group, ste=ste).to(x.dtype)


class FeedForward(nn.Module):
    """MLP, GELU by default (``activation`` another elementwise function: the
    Conformer's swish); under tensor parallelism w1 keeps this rank's rows,
    w2 its columns, and ``tp_group`` is the model group."""

    def __init__(self, cfg: WavLMConfig, device=None, dtype=torch.float32, activation=gelu):
        super().__init__()
        D, Fd = cfg.hidden_size, cfg.intermediate_size
        self.w1 = param((Fd, D), device, dtype)
        self.b1 = param((Fd,), device, dtype)
        self.w2 = param((D, Fd), device, dtype)
        self.b2 = param((D,), device, dtype)
        self.activation = activation
        self.tp_group = None
        self.int8_forward = False  # w1, w2 through qdot_ste (fine-tuning)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.tp_group)
        h = self.activation(linear(x, self.w1, self.b1, ste=self.int8_forward).to(x.dtype))
        return linear(h, self.w2, self.b2, self.tp_group,
                      ste=self.int8_forward).to(x.dtype)


class EncoderLayer(nn.Module):
    """Post-LN layer, or the stable pre-LN layer when
    ``cfg.do_stable_layer_norm`` (WavLM-Large)."""

    def __init__(self, cfg: WavLMConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.stable = cfg.do_stable_layer_norm
        self.eps = cfg.layer_norm_eps
        self.attention = GatedRelPosAttention(cfg, device, dtype)
        self.feed_forward = FeedForward(cfg, device, dtype)
        D = cfg.hidden_size
        self.ln1_s, self.ln1_b = param((D,), device, dtype), param((D,), device, dtype)
        self.ln2_s, self.ln2_b = param((D,), device, dtype), param((D,), device, dtype)

    def forward(self, x, position_bias, key_mask_bias, attention_fn):
        eps = self.eps
        if self.stable:
            attn_in = layer_norm(x, self.ln1_s, self.ln1_b, eps)
            x, ff_in = add_layer_norm(
                x, self.attention(attn_in, position_bias, key_mask_bias, attention_fn),
                self.ln2_s, self.ln2_b, eps)
            return (x + self.feed_forward(ff_in)).to(x.dtype)
        x = x + self.attention(x, position_bias, key_mask_bias, attention_fn)
        x = layer_norm(x, self.ln1_s, self.ln1_b, eps)
        x = x + self.feed_forward(x)
        return layer_norm(x, self.ln2_s, self.ln2_b, eps)


class WavLMModel(nn.Module):
    """WavLM: stem, feature projection, positional conv and the layer stack.

    ``forward`` returns every hidden state (for tests); ``encode`` returns the
    masked mean-pool of the selected states, pooled as the loop runs, so the
    [N+1, B, L, D] stack never exists (the extraction path); both run under
    ``inference_mode``. ``pooled_states`` is the differentiable counterpart
    of ``encode`` for fine-tuning. Parameters are created uninitialised on
    ``device``; fill them with ``weights.convert.init_wavlm`` or
    ``load_state_dict``.
    """

    def __init__(self, cfg: WavLMConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        D, H = cfg.hidden_size, cfg.num_attention_heads
        self.feature_encoder = ConvFeatureEncoder(cfg, device, dtype)
        self.feature_projection = FeatureProjection(cfg, device, dtype)
        self.pos_conv = PosConvEmbedding(cfg, device, dtype)
        self.ln_scale = param((D,), device, dtype)
        self.ln_bias = param((D,), device, dtype)
        self.rel_attn_embed = param((cfg.num_buckets, H), device, dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device, dtype) for _ in range(cfg.num_hidden_layers))
        # SpecAugment's mask embedding: training only, kept so that a JAX
        # parameter tree converts without loss
        self.masked_spec_embed = param((D,), device, dtype)
        self._buckets: dict[tuple[int, torch.device], torch.Tensor] = {}
        # under tensor parallelism: this rank's heads [start, stop) and the
        # model group (parallel.sharding.shard_wavlm)
        self.head_range = (0, H)
        self.tp_group = None

    def position_bias(self, seq_len: int, table: torch.Tensor | None = None) -> torch.Tensor:
        """[H, L, L] f32 bias from the bucket embedding table (``table``
        replaces ``rel_attn_embed``); under tensor parallelism the rank's
        heads' planes, contiguous."""
        table = self.rel_attn_embed if table is None else table
        if self.tp_group is not None:
            start, stop = self.head_range
            table = copy_to_model(table, self.tp_group)[:, start:stop]
        key = (seq_len, table.device)
        if key not in self._buckets:
            cfg = self.cfg
            self._buckets[key] = torch.from_numpy(relative_position_buckets(
                seq_len, cfg.num_buckets, cfg.max_bucket_distance).astype(np.int64)).to(
                    table.device)
        return table[self._buckets[key]].permute(2, 0, 1).float().contiguous()

    def _run(self, waveform, sample_lengths, collect, attention_fn, params=None,
             stop_stem_gradient=False, augment=None, remat=None, plain_stem=False):
        """The forward. ``params`` ({state-dict name: tensor}) replaces the
        module's parameters (the training step's cast weights); ``plain_stem``
        keeps the stem off ``ConvFeatureEncoder.fused``; these and the other
        options are ``pooled_states``'."""
        cfg = self.cfg
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
        attention_fn = attention_fn or gated_relpos_attention

        def call(module, prefix, *args):
            if params is None:
                return module(*args)
            return functional_call(module, {k[len(prefix):]: v for k, v in params.items()
                                            if k.startswith(prefix)}, args)

        def weight(name):
            return getattr(self, name) if params is None else params[name]

        stem = self.feature_encoder
        feats = None if plain_stem else stem.fused(waveform, sample_lengths)
        if feats is None:
            with torch.no_grad() if stop_stem_gradient else contextlib.nullcontext():
                feats = call(stem, "feature_encoder.", waveform, sample_lengths)
        hidden = call(self.feature_projection, "feature_projection.", feats)
        B, L, _ = hidden.shape
        if sample_lengths is not None:
            frame_lengths = wavlm_feature_lengths(cfg, sample_lengths)
        else:
            frame_lengths = torch.full((B,), L, dtype=torch.long, device=hidden.device)
        if augment is not None:  # SpecAugment, before the frame mask and pos conv
            hidden = augment(hidden, frame_lengths, weight("masked_spec_embed"))
        if sample_lengths is not None:
            frame_mask = torch.arange(L, device=hidden.device)[None, :] < frame_lengths[:, None]
            hidden = hidden * frame_mask[:, :, None].to(hidden.dtype)
            key_mask_bias = torch.where(frame_mask, 0.0, -1e9).float()
        else:
            key_mask_bias = torch.zeros((B, L), dtype=torch.float32, device=hidden.device)
        hidden = call(self.pos_conv, "pos_conv.", hidden)
        if not cfg.do_stable_layer_norm:
            hidden = layer_norm(hidden, weight("ln_scale"), weight("ln_bias"),
                                cfg.layer_norm_eps)
        position_bias = self.position_bias(L, weight("rel_attn_embed"))

        layer_context = noop_context_fn
        if remat == "layer_dots":
            layer_context = save_only(GEMMS)
        elif remat == "layer_probs":
            probs = SaveAllButAttention(attention_fn)
            attention_fn = probs.attention
            layer_context = functools.partial(create_selective_checkpoint_contexts,
                                              probs.policy)

        def encoder(hidden):
            collected = []
            for i, layer in enumerate(self.layers):
                collected.append(collect(i, hidden, frame_lengths))  # layer i's INPUT

                def run_layer(h, layer=layer, prefix=f"layers.{i}."):
                    return call(layer, prefix, h, position_bias, key_mask_bias,
                                attention_fn).to(h.dtype)

                hidden = (checkpoint(run_layer, hidden, use_reentrant=False,
                                     context_fn=layer_context)
                          if remat in ("layer", "layer_dots", "layer_probs")
                          else run_layer(hidden))
            if cfg.do_stable_layer_norm:
                hidden = layer_norm(hidden, weight("ln_scale"), weight("ln_bias"),
                                    cfg.layer_norm_eps)
            collected.append(collect(len(self.layers), hidden, frame_lengths))
            return hidden, collected

        if remat in ("nothing", "dots"):
            hidden, collected = checkpoint(
                encoder, hidden, use_reentrant=False,
                context_fn=save_only(UNBATCHED_GEMMS) if remat == "dots" else noop_context_fn)
        else:
            hidden, collected = encoder(hidden)
        return hidden, collected, frame_lengths

    @torch.inference_mode()
    def forward(self, waveform, sample_lengths=None):
        """waveform [B, T] f32 (frontend-normalised); sample_lengths [B] true
        sample counts. Returns (last [B, L, D], hidden states [N+1, B, L, D],
        frame lengths [B]). The stem takes the fused kernel where
        ``ConvFeatureEncoder.fused`` gives its frames."""
        last, states, frame_lengths = self._run(
            waveform, sample_lengths, lambda i, h, fl: h, None)
        return last, torch.stack(states), frame_lengths

    @torch.inference_mode()
    def encode(self, waveform, layer_indices, sample_lengths=None, attention_fn=None):
        """Masked mean-pooled hidden states at ``layer_indices``:
        [len(layer_indices), B, D] f32. ``attention_fn`` replaces the
        attention core (the default is the kernel wrapper); the stem is
        ``forward``'s."""
        wanted = set(layer_indices)

        def collect(i, h, frame_lengths):
            return masked_mean_pool(h, frame_lengths) if i in wanted else None

        _, pooled, _ = self._run(waveform, sample_lengths, collect, attention_fn)
        return torch.stack([pooled[i] for i in layer_indices])

    def pooled_states(self, waveform, sample_lengths=None, params=None,
                      stop_stem_gradient=False, augment=None, remat=None, attention_fn=None):
        """Masked mean-pool of all N+1 hidden states, [N+1, B, D] f32,
        differentiable (the fine-tuning forward).

        - ``params``: {state-dict name: tensor} used in place of the module's
          parameters (the step's cast of the f32 masters, so that gradients
          reach the masters through the cast);
        - ``stop_stem_gradient``: the conv stem runs under ``no_grad``;
        - ``augment(hidden, frame_lengths, masked_spec_embed)``: SpecAugment,
          applied after the feature projection, before the frame mask and
          the positional conv;
        - ``remat``: "layer" checkpoints each layer, "nothing" the whole
          encoder, None neither; "layer_dots" and "dots" do the same but keep
          the GEMMs' outputs (``save_only``), and "layer_probs" checkpoints
          each layer keeping everything but the attention core
          (``SaveAllButAttention``);
        - ``attention_fn``: the attention core, by default the kernel's
          autograd Function."""
        _, pooled, _ = self._run(
            waveform, sample_lengths, lambda i, h, fl: masked_mean_pool(h, fl),
            attention_fn or gated_relpos_attention_diff, params, stop_stem_gradient,
            augment, remat, plain_stem=True)
        return torch.stack(pooled)
