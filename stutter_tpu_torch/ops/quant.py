"""Int8 dynamic quantization of the projection GEMMs: the turbo presets.

Counterpart of ``stutter_tpu/ops/quant.py`` for the inference path (W8A8):
- weights: static symmetric per-output-channel int8, scale = absmax / 127
  over the contraction axis (at least 1e-12), made once when the preset casts
  the model (``extract.pipeline``), from the bf16 weights;
- activations: dynamic symmetric per-token int8, scale = absmax / 127 over
  the features (at least 1e-8), rounded half to even and clipped to +-127;
- int8 x int8 -> int32 products, dequantised by the outer product of the two
  scale vectors: ``acc.float() * s_token * s_channel``.

Weights keep PyTorch's [out, in] layout: ``quantize_weight`` quantizes over
the last axis and a ``QuantizedWeight`` holds int8 [N, K] and its f32 [N]
scale as buffers. ``quantize_layer_stack`` puts one in place of each named
parameter, so that a turbo model holds no bf16 or f32 copy of those weights.
``linear`` dispatches on what it is given, as ``dense`` does in JAX: the
int8 path returns the input's dtype and adds the bias after that cast.

The int8 product is ``torch._int_mm``, as the JAX package leaves its int8
product to XLA outside any Pallas kernel. On CUDA it wants K and N multiples
of 8 and, in some builds, more than 16 rows; fewer rows are padded with zero
rows, which is exact, and sliced off. ``qdot.calls`` counts the int8
products on every device.

Under tensor parallelism (``group``) a row-parallel product holds a slice
of the contraction axis on each rank: the per-token absmax is all-reduced
(MAX) over the model group before quantising, and the int32 accumulators
are summed over it, exactly, so they equal the whole product's, as under the
JAX package's GSPMD.

Fine-tuning's ``int8_forward`` trains through ``qdot_ste``: the forward
quantizes the live weight every call (it changes every update; under a
row-parallel ``group`` its per-channel absmax is all-reduced, MAX, first, so
that every rank holds the whole weight's scale) and takes ``qdot``; the backward is the plain product's, ``dx = g W`` and
``dW = g^T x`` with the cotangent first cast to the weight's dtype, as
JAX's straight-through estimator. ``linear(..., ste=True)`` takes it.

Not ported: ``qdot_asym``/``dense_asym`` (no production caller) and
``quantize_conv_weight`` (the int8-stem experiment).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from stutter_tpu_torch.ops.precision import tf32
from stutter_tpu_torch.parallel.collectives import (
    all_reduce_max,
    all_reduce_sum,
    reduce_from_model,
)

_MIN_ROWS = 17  # torch._int_mm's row minimum on CUDA
_HALF = (torch.bfloat16, torch.float16)

# The per-layer weights turbo quantizes, under the port's parameter names:
# WavLM's q_w, k_w, v_w, o_w, ff_w1, ff_w2, and the Whisper encoder's
# attn_q/k/v_w, fc1_w, fc2_w (the JAX package's key tuples as
# ``cast_params_for_preset`` applies them: it leaves the encoder's attn_o_w
# and the whole decoder in bf16). Everything else (biases, norms, gates,
# rel-pos tables, conv stems, embeddings) keeps the activation dtype.
WAVLM_QUANT_KEYS = ("attention.q_w", "attention.k_w", "attention.v_w", "attention.o_w",
                    "feed_forward.w1", "feed_forward.w2")
WHISPER_QUANT_KEYS = ("attn.q_w", "attn.k_w", "attn.v_w", "ffn.fc1_w", "ffn.fc2_w")
# w2v-BERT (no JAX counterpart): every product of its layers, the conv
# module's pointwise convs included
W2V_BERT_QUANT_KEYS = ("attention.q_w", "attention.k_w", "attention.v_w", "attention.o_w",
                       "ffn1.w1", "ffn1.w2", "ffn2.w1", "ffn2.w2", "conv.pw1_w", "conv.pw2_w")


class QuantizedWeight(nn.Module):
    """An int8 [N, K] weight and its f32 [N] per-output-channel scale."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)


def quantize_weight(w: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """w [..., N, K] -> (int8 [..., N, K], f32 scale [..., N]): symmetric,
    per output channel N, over the contraction axis K. Under tensor
    parallelism (``group``) w is this rank's slice of K, and the absmax is
    taken over the whole axis, as ``quantize_activations`` takes x's."""
    wf = w.float()
    amax = all_reduce_max(wf.abs().amax(dim=-1, keepdim=True), group)
    s = (amax / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s.squeeze(-1)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K, N] -> int32 [M, N]; fewer than 17 rows are
    padded with zero rows and sliced off."""
    M = a.shape[0]
    if M < _MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _MIN_ROWS - M))
    return torch._int_mm(a, b)[:M]


def quantize_activations(x: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., K] -> (int8 [..., K], f32 per-token scale [..., 1]). Under
    tensor parallelism (``group``) x is this rank's slice of the contraction
    axis, and the absmax is taken over the whole axis: the slices' maxima are
    all-reduced (MAX) over the group first."""
    xf = x.float()
    amax = all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), group)
    st = (amax / 127.0).clamp_min(1e-8)
    return torch.clamp(torch.round(xf / st), -127, 127).to(torch.int8), st


def qdot_accumulators(x: torch.Tensor, q: torch.Tensor,
                      group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32 accumulators [..., N], per-token scale [..., 1]) of x against
    q [N, K]. With ``group`` (a row-parallel product: x and q hold this
    rank's slice of K) the int32 partial sums are all-reduced over the group,
    which is exact: the accumulators equal the whole product's."""
    xq, st = quantize_activations(x, group)
    K, N = q.shape[1], q.shape[0]
    acc = int_mm(xq.reshape(-1, K), q.t()).view(*x.shape[:-1], N)
    return all_reduce_sum(acc, group), st


def qdot(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, group=None) -> torch.Tensor:
    """x [..., K] (bf16/f32) against an int8 weight q [N, K] with scales s
    [N] -> f32 [..., N]; ``group`` as in ``qdot_accumulators`` (s is then
    whole)."""
    acc, st = qdot_accumulators(x, q, group)
    qdot.calls += 1
    return acc.float() * st * s


qdot.calls = 0


class QdotSTE(torch.autograd.Function):
    """``qdot`` of x against the int8 quantization of the live weight w
    [N, K] -> f32 [..., N]; gradients of the plain product x @ w^T."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        return qdot(x, *quantize_weight(w, group), group)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(w.dtype)  # the cotangent arrives f32, as the forward's output
        dx = torch.matmul(g, w).to(x.dtype)
        dw = torch.matmul(g.reshape(-1, g.shape[-1]).t(), x.reshape(-1, x.shape[-1]))
        return dx, dw.to(w.dtype), None


def qdot_ste(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """int8 forward, straight-through backward (``QdotSTE``); ``group`` as
    in ``qdot_accumulators``."""
    return QdotSTE.apply(x, w, group)


def linear(x: torch.Tensor, w, b: torch.Tensor | None = None, group=None,
           ste: bool = False) -> torch.Tensor:
    """x @ w^T (+ b): the int8 path for a ``QuantizedWeight`` or, with
    ``ste``, ``qdot_ste`` of a float weight (cast to x's dtype, then the bias
    added), else ``F.linear``.

    ``group`` makes it a row-parallel product of tensor parallelism: x holds
    this rank's slice of the features and w the matching columns. The
    partial products are summed over the group before the bias, which is
    whole and added once: the int8 path's int32 accumulators exactly, the
    float path's f32 partials, then the bias in f32 and one cast to x's
    dtype. The float partials are f32 products of the upcast operands; bf16
    or f16 operands are exact in TF32, so that product takes the tensor
    cores (``tf32``), where f32 operands keep full f32."""
    if isinstance(w, QuantizedWeight) or ste:
        y = (qdot(x, w.q, w.s, group) if isinstance(w, QuantizedWeight)
             else qdot_ste(x, w, group)).to(x.dtype)
        return y if b is None else y + b
    if group is None:
        return F.linear(x, w, b)
    half = x.dtype in _HALF and w.dtype in _HALF
    with tf32() if half else contextlib.nullcontext():
        y = F.linear(x.float(), w.float())
    y = reduce_from_model(y, group)
    return (y if b is None else y + b.float()).to(x.dtype)


def quantize_layer_stack(layers, keys: tuple[str, ...]) -> None:
    """Put a ``QuantizedWeight`` in place of each parameter named in ``keys``
    (dotted names under each layer) of every layer, in place. Names a layer
    does not have are skipped, as the JAX package skips absent keys."""
    for layer in layers:
        for key in keys:
            *path, name = key.split(".")
            owner = layer
            for part in path:
                owner = getattr(owner, part, None)
                if owner is None:
                    break
            if owner is None or not isinstance(owner._parameters.get(name), torch.Tensor):
                continue
            w = owner._parameters.pop(name)
            setattr(owner, name, QuantizedWeight(*quantize_weight(w.detach())))
