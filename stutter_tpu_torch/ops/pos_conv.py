"""The positional conv of WavLM and wav2vec2 with its epilogue and the
residual add, in one call: the hand-written CUDA kernel and its plain version.

hidden [B, L, D] -> hidden + pos_conv(hidden), where pos_conv is the grouped
SamePad conv of ``models.wavlm.PosConvEmbedding``: 128 taps, ``groups``
groups of Cg = D / groups channels, the bias added in f32, the last frame
dropped, the erf GELU in f32, cast to hidden's dtype, then added to hidden
in its dtype (an f32 add rounded once). The JAX package's counterpart is
``stutter_tpu/models/wavlm.py:pos_conv_embedding`` and the add after it, an
XLA convolution: the kernel replaces no Pallas kernel.

``pack_pos_conv_weights`` lays the [D, Cg, 128] weight out once as the
kernel reads it: [G, 64 * Cg / 8, 2, Cg, 8] bf16, k-step s = p * (Cg / 8) + k
holding the B tile of tap pair p and input chunk k, ``[h][n][i] = W[g Cg + n,
8 k + i, 2 p + h]`` (the K-major, non-swizzled tile of ``csrc/pos_conv.cu``:
K values 0-7 are tap 2 p, 8-15 tap 2 p + 1 of the same 8 channels). No
channel is padded: Cg = 120 is 15 whole chunks. ``unpack_pos_conv_weights``
is its inverse. ``PosConvEmbedding`` packs for each call (one copy of the
weight, freed after the call, so that no second copy stays on the card).

``pos_conv_residual`` launches ``csrc/pos_conv.cu`` for CUDA tensors and
counts each launch in ``pos_conv_residual.launches``; for CPU tensors it
runs ``pos_conv_residual_reference``, the plain version in f32, which the
tests and the on-card comparison also use. ``kernel_applies`` is the
module's gate: bf16 input and weight on the card, 128 taps, Cg of 64 or 120
(the kernel's instances) and no autograd; everywhere else the module runs
its plain PyTorch path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stutter_tpu_torch.ops.precision import no_tf32

TAPS = 128  # the kernel's conv width (num_conv_pos_embeddings)
GROUP_WIDTHS = (64, 120)  # channels a group of the kernel's instances
_CHUNK = 8  # input channels a core matrix row


def pack_pos_conv_weights(weight: torch.Tensor) -> torch.Tensor:
    """[D, Cg, 128] (any float dtype) -> the kernel's bf16 [G, 64 Cg / 8, 2, Cg, 8]."""
    D, Cg, k = weight.shape
    if k != TAPS or Cg % _CHUNK:
        raise ValueError(f"the pack takes [D, Cg, {TAPS}] with Cg a multiple of {_CHUNK}, "
                         f"got {tuple(weight.shape)}")
    G, chunks = D // Cg, Cg // _CHUNK
    w = weight.detach().to(torch.bfloat16).reshape(G, Cg, chunks, _CHUNK, TAPS // 2, 2)
    # [g, n, k, i, p, h] -> [g, p, k, h, n, i]
    return w.permute(0, 4, 2, 5, 1, 3).reshape(G, TAPS // 2 * chunks, 2, Cg, _CHUNK).contiguous()


def unpack_pos_conv_weights(packed: torch.Tensor) -> torch.Tensor:
    """``pack_pos_conv_weights``'s inverse: -> [D, Cg, 128]."""
    G, _, _, Cg, _ = packed.shape
    w = packed.reshape(G, TAPS // 2, Cg // _CHUNK, 2, Cg, _CHUNK)
    return w.permute(0, 4, 2, 5, 1, 3).reshape(G * Cg, Cg, TAPS)


def pos_conv_residual_reference(hidden: torch.Tensor, weight: torch.Tensor,
                                bias: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain version: hidden [B, L, D], weight [D, D / groups, k], bias [D]
    -> hidden + pos_conv(hidden) in hidden's dtype, the conv in f32 (no TF32)
    on the weight's values."""
    L, k = hidden.shape[1], weight.shape[2]
    x = hidden.float()
    with no_tf32():
        y = F.conv1d(x.transpose(1, 2), weight.float(), padding=k // 2, groups=groups)
    y = (y + bias.float()[None, :, None])[:, :, :L]  # SamePad drops the last frame at even k
    g = F.gelu(y).to(hidden.dtype).float().transpose(1, 2)
    return (x + g).to(hidden.dtype)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def kernel_applies(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   kernel: int, groups: int) -> bool:
    """Whether ``PosConvEmbedding`` runs ``pos_conv_residual``'s kernel: bf16
    input and weight on the card, ``TAPS`` taps, a group width the kernel is
    built for, and no autograd (grad off, or nothing that requires it)."""
    return (_on_card(x) and x.dtype == weight.dtype == torch.bfloat16
            and kernel == TAPS and weight.shape[1] in GROUP_WIDTHS
            and not (torch.is_grad_enabled()
                     and (x.requires_grad or weight.requires_grad or bias.requires_grad)))


def _check(hidden, weights, bias, groups) -> None:
    if hidden.dim() != 3 or hidden.dtype != torch.bfloat16:
        raise ValueError(f"hidden must be bf16 [B, L, D], got {hidden.dtype} "
                         f"{tuple(hidden.shape)}")
    B, L, D = hidden.shape
    if not (0 < B and 0 < L) or D % groups or D // groups not in GROUP_WIDTHS:
        raise ValueError(f"no kernel for [B, L, D] = {tuple(hidden.shape)} in {groups} groups")
    Cg = D // groups
    shape = (groups, TAPS // 2 * Cg // _CHUNK, 2, Cg, _CHUNK)
    for name, t, want, dtype in (("weights", weights, shape, torch.bfloat16),
                                 ("bias", bias, (D,), torch.float32)):
        if tuple(t.shape) != want or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {want}, got "
                             f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
        if t.device != hidden.device:
            raise ValueError(f"{name} is on {t.device}, hidden on {hidden.device}")
    if hidden.data_ptr() % 16 or weights.data_ptr() % 16 or bias.data_ptr() % 8:
        raise ValueError("hidden and the weights must be 16-byte aligned, the bias 8")


def pos_conv_residual(hidden: torch.Tensor, weights: torch.Tensor, bias: torch.Tensor,
                      groups: int) -> torch.Tensor:
    """hidden [B, L, D] (padded frames zero), weights from
    ``pack_pos_conv_weights``, bias [D] f32 -> hidden + pos_conv(hidden)."""
    if hidden.device.type == "cpu":
        return pos_conv_residual_reference(hidden, unpack_pos_conv_weights(weights), bias,
                                           groups)
    if hidden.device.type != "cuda":
        raise ValueError(f"no kernel for device {hidden.device}")
    hidden = hidden.contiguous()
    _check(hidden, weights, bias, groups)
    from stutter_tpu_torch.ops._build import kernel_library

    lib = kernel_library()
    B, L, D = hidden.shape
    out = torch.empty_like(hidden)
    with torch.cuda.device(hidden.device):
        stream = torch.cuda.current_stream(hidden.device).cuda_stream
        rc = lib.pos_conv_residual(hidden.data_ptr(), weights.data_ptr(), bias.data_ptr(),
                                   out.data_ptr(), B, L, D, groups, stream)
    if rc != 0:
        raise RuntimeError(f"pos_conv_residual launch failed: CUDA error {rc}")
    pos_conv_residual.launches += 1
    return out


pos_conv_residual.launches = 0
