"""w2v-BERT 2.0 in PyTorch: a Conformer speech encoder beside WavLM and wav2vec2.

The speech encoder of SeamlessM4T (arXiv:2308.11596), pre-trained as
w2v-BERT (Chung et al. 2021, arXiv:2108.06209), laid out as HF's
``Wav2Vec2BertModel`` and its ``config.json`` name it. The JAX package has
no counterpart. Its input is ``frontend/w2v_bert_frontend.py``'s stacked
Kaldi fbank, [B, L, 160] rows of 20 ms; then a feature projection (a layer
norm and a linear map to the hidden width) and Conformer layers (Gulati et
al. 2020, arXiv:2005.08100), each::

    x = x + 1/2 FFN1(LN(x))                        swish FFNs, with biases
    x = x + Attn(LN(x))                            q, k, v, o with biases
    x = x + Conv(x)
    x = LN(x + 1/2 FFN2(LN(x)))

Attn adds a clamped relative-key term to each score (``ops.relkey_attention``:
the hand-written kernel on the card, its plain version on the CPU). Conv is
LN, padded frames zeroed, a pointwise conv to twice the width (no bias), a
GLU, a causal depthwise conv (kernel 31, left-padded, no bias), LN, swish and
a pointwise conv (no bias). There is no positional conv and no norm after the
last layer. Hidden state 0 is the projection, padded frames zeroed; state i
is layer i's output. Keys past each clip's rows are masked with -1e9, so a
padded batch equals per-clip runs.

Norms take ``models/common.py``'s ``layer_norm`` and ``add_layer_norm``
(each residual add feeds the next norm in one call), the linear maps
``ops.quant.linear`` (turbo's int8 path reaches every product, the conv
module's pointwise convs included) and the FFNs WavLM's ``FeedForward``
with swish. The parameters hold two factors folded in at load: the macaron
FFNs' 1/2 in each FFN's w2 and b2, and q's head_dim^-1/2 in q's weight and
bias (``W2VBertModel.folds``), so that the forward multiplies by neither; the
state dict keeps the published values. The other numerics are WavLM's in
this package: f32 norm statistics cast back to the activation dtype, keys
masked with -1e9.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from stutter_tpu_torch.models.common import add_layer_norm, layer_norm, param
from stutter_tpu_torch.models.wavlm import FeedForward
from stutter_tpu_torch.ops.pooling import masked_mean_pool
from stutter_tpu_torch.ops.quant import linear
from stutter_tpu_torch.ops.relkey_attention import relkey_self_attention

SWISH = ("swish", "silu")


@dataclasses.dataclass(frozen=True)
class W2VBertConfig:
    """HF ``Wav2Vec2BertConfig``'s fields that the forward reads, by their
    ``config.json`` names, and the frontend's (``preprocessor_config.json``);
    the defaults are w2v-bert-2.0's. Other position embeddings, an adapter,
    the intermediate FFN before it and an activation other than swish are
    refused."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    feature_projection_input_dim: int = 160
    hidden_act: str = "swish"
    position_embeddings_type: str = "relative_key"
    left_max_position_embeddings: int = 64
    right_max_position_embeddings: int = 8
    conv_depthwise_kernel_size: int = 31
    layer_norm_eps: float = 1e-5
    add_adapter: bool = False
    use_intermediate_ffn_before_adapter: bool = False
    # frontend (SeamlessM4TFeatureExtractor)
    num_mel_bins: int = 80
    stride: int = 2
    sampling_rate: int = 16000

    def __post_init__(self):
        if self.position_embeddings_type != "relative_key":
            raise ValueError(f"position_embeddings_type {self.position_embeddings_type!r} is "
                             "not ported; the port computes relative_key")
        if (self.left_max_position_embeddings, self.right_max_position_embeddings) != (64, 8):
            raise ValueError("the relative-key attention is built for distances clamped to "
                             "[-64, 8]")
        if self.add_adapter or self.use_intermediate_ffn_before_adapter:
            raise ValueError("the adapter and the intermediate FFN before it are not ported")
        if self.hidden_act not in SWISH:
            raise ValueError(f"hidden_act {self.hidden_act!r}: the port computes swish only")
        if self.feature_projection_input_dim != self.num_mel_bins * self.stride:
            raise ValueError(f"feature_projection_input_dim {self.feature_projection_input_dim} "
                             f"is not num_mel_bins {self.num_mel_bins} x stride {self.stride}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def w2v_bert_2_0() -> "W2VBertConfig":
        """facebook/w2v-bert-2.0: 24 layers of 1024, 16 heads of 64, FFN 4096."""
        return W2VBertConfig()

    @staticmethod
    def tiny(hidden_size: int = 64, layers: int = 2, heads: int = 4) -> "W2VBertConfig":
        """Small config for the CPU tests: w2v-BERT's code paths, its frontend
        and its kernel of 31."""
        return W2VBertConfig(hidden_size=hidden_size, num_hidden_layers=layers,
                             num_attention_heads=heads, intermediate_size=2 * hidden_size)


class FeatureProjection(nn.Module):
    """LN over the 160 stacked fbank values, then Linear(160 -> hidden)."""

    def __init__(self, cfg: W2VBertConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = cfg.layer_norm_eps
        c = cfg.feature_projection_input_dim
        self.ln_scale = param((c,), device, dtype)
        self.ln_bias = param((c,), device, dtype)
        self.weight = param((cfg.hidden_size, c), device, dtype)
        self.bias = param((cfg.hidden_size,), device, dtype)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        feats = layer_norm(feats, self.ln_scale, self.ln_bias, self.eps)
        return F.linear(feats, self.weight, self.bias).to(feats.dtype)


class RelKeyAttention(nn.Module):
    """Multi-head self-attention with the clamped relative-key term; weights
    are [out, in], by WavLM's attention's names (turbo's keys apply), q_w
    and q_b with head_dim^-1/2 folded in; ``distance_embedding`` is
    [73, head_dim]."""

    def __init__(self, cfg: W2VBertConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.head_dim
        D = cfg.hidden_size
        for name in ("q", "k", "v", "o"):
            setattr(self, f"{name}_w", param((D, D), device, dtype))
            setattr(self, f"{name}_b", param((D,), device, dtype))
        terms = cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1
        self.distance_embedding = param((terms, self.head_dim), device, dtype)

    def forward(self, x: torch.Tensor, kv_valid: torch.Tensor | None) -> torch.Tensor:
        B, L, D = x.shape
        H, hd = self.heads, self.head_dim

        def heads(t):  # [B, L, D] -> a [B, H, L, hd] view
            return t.view(B, L, H, hd).transpose(1, 2)

        q = linear(x, self.q_w, self.q_b).to(x.dtype)  # pre-scaled by the fold
        k = linear(x, self.k_w, self.k_b).to(x.dtype)
        v = linear(x, self.v_w, self.v_b).to(x.dtype)
        out = relkey_self_attention(heads(q), heads(k), heads(v), self.distance_embedding,
                                    kv_valid)
        return linear(out.transpose(1, 2).reshape(B, L, D), self.o_w, self.o_b).to(x.dtype)


class ConvModule(nn.Module):
    """The Conformer's convolution module after its first norm (whose scale
    and bias, ``ln_s`` and ``ln_b``, the layer applies with the residual add
    in front of it): padded frames zeroed, pw1 [2D, D], GLU, the causal
    depthwise conv dw_w [D, 1, k], LN, swish, pw2 [D, D]. The sequence stays
    [B, L, D]: the depthwise conv is cuDNN's, on the channels-last view of
    the GLU's output written after k - 1 zero frames."""

    def __init__(self, cfg: W2VBertConfig, device=None, dtype=torch.float32):
        super().__init__()
        D, k = cfg.hidden_size, cfg.conv_depthwise_kernel_size
        self.eps = cfg.layer_norm_eps
        self.kernel = k
        self.ln_s, self.ln_b = param((D,), device, dtype), param((D,), device, dtype)
        self.pw1_w = param((2 * D, D), device, dtype)
        self.dw_w = param((D, 1, k), device, dtype)
        self.dw_ln_s, self.dw_ln_b = param((D,), device, dtype), param((D,), device, dtype)
        self.pw2_w = param((D, D), device, dtype)

    def forward(self, h: torch.Tensor, frame_mask: torch.Tensor | None) -> torch.Tensor:
        B, L, D = h.shape
        pad = self.kernel - 1
        glu = F.glu(linear(h, self.pw1_w).to(h.dtype), dim=-1)
        # zeroing the GLU's padded frames zeroes pw1's input there (no bias)
        padded = h.new_empty((B, pad + L, D))
        padded[:, :pad].zero_()
        if frame_mask is None:
            padded[:, pad:].copy_(glu)
        else:
            torch.mul(glu, frame_mask, out=padded[:, pad:])
        y = F.conv2d(padded.view(B, 1, pad + L, D).permute(0, 3, 1, 2),
                     self.dw_w.view(D, 1, 1, self.kernel), groups=D)
        y = y.permute(0, 2, 3, 1).reshape(B, L, D)  # a view where cuDNN kept channels last
        y = F.silu(layer_norm(y, self.dw_ln_s, self.dw_ln_b, self.eps))
        return linear(y, self.pw2_w).to(h.dtype)


class ConformerLayer(nn.Module):
    """Macaron FFN, relative-key attention, convolution module, macaron FFN,
    final norm; each FFN's w2 and b2 hold the half-step's 1/2."""

    def __init__(self, cfg: W2VBertConfig, device=None, dtype=torch.float32):
        super().__init__()
        D = cfg.hidden_size
        self.eps = cfg.layer_norm_eps
        for name in ("ffn1_ln", "attn_ln", "ffn2_ln", "final_ln"):
            setattr(self, f"{name}_s", param((D,), device, dtype))
            setattr(self, f"{name}_b", param((D,), device, dtype))
        self.ffn1 = FeedForward(cfg, device, dtype, activation=F.silu)
        self.attention = RelKeyAttention(cfg, device, dtype)
        self.conv = ConvModule(cfg, device, dtype)
        self.ffn2 = FeedForward(cfg, device, dtype, activation=F.silu)

    def forward(self, x: torch.Tensor, kv_valid: torch.Tensor | None,
                frame_mask: torch.Tensor | None) -> torch.Tensor:
        eps = self.eps
        h = layer_norm(x, self.ffn1_ln_s, self.ffn1_ln_b, eps)
        x, h = add_layer_norm(x, self.ffn1(h), self.attn_ln_s, self.attn_ln_b, eps)
        x, h = add_layer_norm(x, self.attention(h, kv_valid), self.conv.ln_s, self.conv.ln_b,
                              eps)
        x, h = add_layer_norm(x, self.conv(h, frame_mask), self.ffn2_ln_s, self.ffn2_ln_b, eps)
        return add_layer_norm(x, self.ffn2(h), self.final_ln_s, self.final_ln_b, eps)[1]


class W2VBertModel(nn.Module):
    """w2v-BERT: the feature projection and the Conformer layers.

    ``forward`` returns every hidden state (for tests); ``encode`` the masked
    mean-pool of the selected states, pooled as the loop runs (the
    extraction path); both run under ``inference_mode`` on the frontend's
    features and valid rows. Parameters are created uninitialised on
    ``device``; fill them with ``weights.convert.load_w2v_bert`` or
    ``load_state_dict``. The state dict holds the published values, the
    parameters the ``folds``: loading multiplies the loaded ones by their
    factor and ``state_dict`` divides them out again, exactly where the
    factor is a power of two (1/2, and 1/8 at heads of 64). A turbo model's
    int8 weights keep the folded values.
    """

    def __init__(self, cfg: W2VBertConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.feature_projection = FeatureProjection(cfg, device, dtype)
        self.layers = nn.ModuleList(
            ConformerLayer(cfg, device, dtype) for _ in range(cfg.num_hidden_layers))
        self.register_load_state_dict_post_hook(_fold_loaded)
        self.register_state_dict_post_hook(_unfold_saved)

    def folds(self) -> dict[str, float]:
        """{parameter name: the factor its published value is held at}."""
        q = self.cfg.head_dim ** -0.5
        factors = {}
        for i in range(self.cfg.num_hidden_layers):
            for name in ("ffn1.w2", "ffn1.b2", "ffn2.w2", "ffn2.b2"):
                factors[f"layers.{i}.{name}"] = 0.5
            for name in ("attention.q_w", "attention.q_b"):
                factors[f"layers.{i}.{name}"] = q
        return factors

    def _run(self, features, frame_lengths, collect):
        hidden = self.feature_projection(features)
        B, L, _ = hidden.shape
        kv_valid = frame_mask = None
        if frame_lengths is not None:
            frame_mask = (torch.arange(L, device=hidden.device)[None, :]
                          < frame_lengths[:, None]).to(hidden.dtype)[..., None]
            hidden = hidden * frame_mask
            kv_valid = frame_lengths.to(torch.int32).contiguous()
        else:
            frame_lengths = torch.full((B,), L, dtype=torch.long, device=hidden.device)
        collected = [collect(0, hidden, frame_lengths)]
        for i, layer in enumerate(self.layers):
            hidden = layer(hidden, kv_valid, frame_mask)
            collected.append(collect(i + 1, hidden, frame_lengths))
        return hidden, collected, frame_lengths

    @torch.inference_mode()
    def forward(self, features, frame_lengths=None):
        """features [B, L, 160] (the frontend's, in the model's dtype);
        frame_lengths [B] valid rows. Returns (last [B, L, D], hidden states
        [N+1, B, L, D], frame lengths [B])."""
        last, states, frame_lengths = self._run(features, frame_lengths, lambda i, h, fl: h)
        return last, torch.stack(states), frame_lengths

    @torch.inference_mode()
    def encode(self, features, layer_indices, frame_lengths=None):
        """Masked mean-pooled hidden states at ``layer_indices``:
        [len(layer_indices), B, D] f32."""
        wanted = set(layer_indices)

        def collect(i, h, frame_lengths):
            return masked_mean_pool(h, frame_lengths) if i in wanted else None

        _, pooled, _ = self._run(features, frame_lengths, collect)
        return torch.stack([pooled[i] for i in layer_indices])


@torch.no_grad()
def _fold_loaded(model: W2VBertModel, incompatible) -> None:
    missing = set(incompatible.missing_keys)
    params = dict(model.named_parameters())
    for name, factor in model.folds().items():
        if name in params and name not in missing:
            params[name].mul_(factor)


def _unfold_saved(model: W2VBertModel, state: dict, prefix: str, local_metadata) -> None:
    for name, factor in model.folds().items():
        if prefix + name in state:
            state[prefix + name] = state[prefix + name] / factor
