"""The encoders' last-axis layer norm, alone or with the residual add in front
of it, in one call: the hand-written CUDA kernel and its plain version.

x [..., D] -> (s, LN(s)), where s is x, or x + delta rounded to x's dtype
when ``delta`` is given (the pre-LN layers' ``x = x + attention(...)``
followed by the second norm). LN takes f32 statistics in two passes (the
mean, then the mean of the squared deviations), multiplies by
``rsqrt(var + eps)``, then the f32 scale and adds the f32 bias (upcast from
the parameters), and rounds once to x's dtype. The JAX package's norm
(``stutter_tpu/models/wavlm.py:layer_norm``, ``whisper.py:_layer_norm``) was
fused by XLA: the kernel replaces no Pallas kernel.

``add_layer_norm`` is the one entry point. Where ``kernel_applies`` (bf16 x,
delta, scale and bias on the card, contiguous and 16-byte aligned, a width
the kernel is built for (``WIDTHS``, multiples of 128: a width such as
w2v-BERT's 160 takes the plain version), at least one row, and no autograd:
grad off, or nothing that requires it) it launches ``csrc/layer_norm.cu`` and counts the
launch in ``add_layer_norm.launches``, a fused one also in
``add_layer_norm.launches_fused``. Everywhere else it runs the plain
version, ``add_layer_norm_reference``, which the tests and the on-card
comparison also use.
"""

from __future__ import annotations

import torch

# the kernel's instances: the stem's channels, then D. A lane loads 4 bf16 at
# a time across a 32-lane row, so a width is a multiple of 128; others (w2v-BERT's
# 160-wide feature projection norm) take the plain path
WIDTHS = (512, 1024, 1280, 1920)


def layer_norm_reference(x: torch.Tensor, scale, bias, eps: float, dim: int = -1) -> torch.Tensor:
    """Plain version: the norm over `dim` with f32 statistics, cast back to
    x's dtype; scale and bias broadcast along `dim`."""
    xf = x.float()
    mean = xf.mean(dim=dim, keepdim=True)
    var = (xf - mean).square().mean(dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    out = (xf - mean) * torch.rsqrt(var + eps) * scale.view(shape) + bias.view(shape)
    return out.to(x.dtype)


def add_layer_norm_reference(x: torch.Tensor, delta: torch.Tensor | None, scale, bias,
                             eps: float):
    """Plain version of ``add_layer_norm``: (s, LN(s)) over the last axis."""
    s = x if delta is None else x + delta
    return s, layer_norm_reference(s, scale, bias, eps)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _bf16_rows(t: torch.Tensor, shape) -> bool:
    """bf16 of ``shape``, contiguous and 16-byte aligned (the kernel's loads)."""
    return (t.dtype == torch.bfloat16 and tuple(t.shape) == tuple(shape) and t.is_contiguous()
            and t.data_ptr() % 16 == 0)


def kernel_applies(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   delta: torch.Tensor | None = None) -> bool:
    """Whether the last-axis norm of x (of x + delta, where given) runs the
    kernel: x (and delta, of x's shape) bf16 on the card, contiguous and
    16-byte aligned, a width in ``WIDTHS``, at least one row, scale and bias
    bf16 [D] on x's device, contiguous and aligned too, and no autograd
    (grad off, or nothing that requires it)."""
    tensors = (x, scale, bias) if delta is None else (x, scale, bias, delta)
    D = x.shape[-1] if x.dim() else 0
    return (_on_card(x)
            and not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))
            and D in WIDTHS and x.numel() > 0 and _bf16_rows(x, x.shape)
            and (delta is None or (_bf16_rows(delta, x.shape) and delta.device == x.device))
            and _bf16_rows(scale, (D,)) and _bf16_rows(bias, (D,))
            and scale.device == bias.device == x.device)


def _launch(x, delta, scale, bias, eps):
    """One launch of ``csrc/layer_norm.cu`` on tensors the gate passed."""
    from stutter_tpu_torch.ops._build import kernel_library

    lib = kernel_library()
    out = torch.empty_like(x)
    s = x if delta is None else torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.layer_norm_bf16(x.data_ptr(), None if delta is None else delta.data_ptr(),
                                 scale.data_ptr(), bias.data_ptr(), s.data_ptr(), out.data_ptr(),
                                 x.numel() // x.shape[-1], x.shape[-1], float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_bf16 launch failed: CUDA error {rc}")
    return s, out


def add_layer_norm(x: torch.Tensor, delta: torch.Tensor | None, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float):
    """(s, LN(s)) over the last axis, s = x or x + delta: the kernel where
    ``kernel_applies``, the plain version elsewhere."""
    if not kernel_applies(x, scale, bias, delta):
        return add_layer_norm_reference(x, delta, scale, bias, eps)
    s, out = _launch(x, delta, scale, bias, eps)
    add_layer_norm.launches += 1
    add_layer_norm.launches_fused += delta is not None
    return s, out


add_layer_norm.launches = 0
add_layer_norm.launches_fused = 0
