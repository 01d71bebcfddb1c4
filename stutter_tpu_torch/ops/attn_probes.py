"""The two A/B probes of WavLM's long attention kernel: int8 operands, and
variants of the softmax chain.

Counterparts of the Pallas kernels of ``scripts/attn_int8_probe.py``
(``_int8_kernel``) and ``scripts/attn_softmax_variants_probe.py``
(``make_kernel``). Both compute the long kernel's function::

    out = softmax_rows(q @ k^T + gate[..., None] * bias + mask[:, None, None, :]) @ v

on bf16 [B, H, L, 64] q (pre-scaled), k and v, with bias [H, L, L], gate
[B, H, L] and mask [B, L] in f32, in another arithmetic:

- ``int8_attention_long``: q and k quantised per row, v per column (over
  the L keys), symmetric int8 with scale max(absmax, 1e-8) / 127; both
  products int8 with int32 sums; the probabilities quantised with the fixed
  scale 127. That scale rounds a diffuse row's ~1/L probabilities to 0, so
  the output is far from f32 (a cosine distance of ~0.1-0.4): the probe's
  known flaw (``scripts/attn_int8_probe.py:15-21``), kept as it is.
- ``softmax_variant_attention(..., postnorm, bf16chain)``: A (neither) the
  f32 chain, a = bf16(e / r), then a @ v; B (postnorm) bf16(e) @ v, divided
  by r after; C (bf16chain) the chain in bf16, rounded after every
  operation, r summed in f32, a = bf16(e * bf16(1 / r)); D both.

The wrappers launch the hand-written CUDA kernels of ``csrc/attn_probes.cu``
for CUDA tensors and count each call in ``.launches``; for CPU tensors they
run the plain versions (``*_reference``), which transcribe the probe
kernels' math line for line and which the tests hold against the Pallas
kernels. The kernels run on the wgmma tiles of the gated attention (64 query
rows a block, 64-key tiles); the int8 kernel stages each key tile with its
keys in ``key_permutation``'s order, so that the scores' accumulators are
the A fragments of the second product.
"""

from __future__ import annotations

import torch

from stutter_tpu_torch.ops.wavlm_attention import _check as check_gated_inputs

# the probes' four variants: name -> (postnorm, bf16chain)
VARIANTS = {"A_incumbent": (False, False), "B_postnorm": (True, False),
            "C_bf16chain": (False, True), "D_both": (True, True)}
BLOCK_Q = 64    # the kernels' query rows per block: one warpgroup's wgmma tile
KEY_ALIGN = 64  # the transposed int8 v is padded to a multiple of the kernel's key tile


def key_permutation() -> list[int]:
    """The int8 kernel's order of the keys of a 64-key tile: row c of the
    staged kq tile holds key ``sigma[c]``. Column c = 8 nt + 2 tig + j of a
    score accumulator lies with lane tig of its row's quad (n-tile nt, j < 2),
    and the int8 A fragment of the second product gives lane tig the keys
    16 h + 32 kk + 4 tig .. + 3 (register 2 h + row of k-step kk, one byte a
    key), so n-tiles 4 kk + 2 h and 4 kk + 2 h + 1 fill that register's bytes
    0, 1 and 2, 3: sigma(c) = 16 (nt // 2) + 4 tig + 2 (nt % 2) + j."""
    return [16 * (c // 16) + 4 * ((c % 8) // 2) + 2 * ((c // 8) % 2) + c % 2 for c in range(64)]


def padded_length(L: int) -> int:
    """Lp: L rounded up to KEY_ALIGN, the key count of the transposed vq."""
    return -(-L // KEY_ALIGN) * KEY_ALIGN


def transpose_padded_reference(vq: torch.Tensor) -> torch.Tensor:
    """The prologue's layout of the int8 v: [B, H, L, 64] -> [B, H, 64, Lp],
    zeros past L (the K-major B operand of aq . vq, whole key tiles)."""
    B, H, L, d = vq.shape
    out = torch.zeros((B, H, d, padded_length(L)), dtype=vq.dtype, device=vq.device)
    out[..., :L] = vq.transpose(-1, -2)
    return out


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, kept in f32."""
    return x.to(torch.bfloat16).float()


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-8) / 127 with IEEE division: on CUDA tensors PyTorch
    multiplies by the reciprocal of a Python-number divisor, which can miss
    the quotient by one ulp, so the 127 is a tensor."""
    return absmax.clamp_min(1e-8) / torch.full_like(absmax, 127.0)


def _quantize_rows(x: torch.Tensor):
    """Symmetric int8 over the last axis: (int8 values, f32 scale [..., 1])."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return torch.round(xf / scale).to(torch.int8), scale


def quantize_kv_reference(k: torch.Tensor, v: torch.Tensor):
    """k per row and v per column (over the keys): (kq [B, H, L, 64] int8,
    sk [B, H, L] f32, vq [B, H, L, 64] int8, sv [B, H, 64] f32)."""
    kq, sk = _quantize_rows(k)
    vf = v.float()
    sv = _scale(vf.abs().amax(dim=-2, keepdim=True))
    return kq, sk[..., 0], torch.round(vf / sv).to(torch.int8), sv[..., 0, :]


def int8_attention_long_reference(q, k, v, bias, gate, mask):
    """Plain version of the int8 probe, [B, H, L, 64] in q's dtype."""
    qq, sq = _quantize_rows(q)
    kq, sk, vq, sv = quantize_kv_reference(k, v)
    # the int8 products summed in f32 are exact: every partial sum is an
    # integer below 2^24 (|q . k| <= 64 * 127^2; |a . v| <= 127 (127 + L / 2))
    s = torch.matmul(qq.float(), kq.float().transpose(-1, -2)) * sq * sk[..., None, :]
    p = s + gate[..., None] * bias[None] + mask[:, None, None, :]
    e = torch.exp(p - p.amax(dim=-1, keepdim=True))
    a = e / e.sum(dim=-1, keepdim=True)
    aq = torch.round(a * 127.0).to(torch.int8)
    o = torch.matmul(aq.float(), vq.float())
    return (o * (1.0 / 127.0) * sv[..., None, :]).to(q.dtype)


def softmax_variant_attention_reference(q, k, v, bias, gate, mask, postnorm: bool,
                                        bf16chain: bool):
    """Plain version of one softmax variant, [B, H, L, 64] in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bf16chain:
        gb = _bf16(_bf16(gate)[..., None] * _bf16(bias)[None])
        p = _bf16(_bf16(_bf16(s) + gb) + _bf16(mask)[:, None, None, :])
        e = _bf16(torch.exp(_bf16(p - p.amax(dim=-1, keepdim=True))))
    else:
        p = s + gate[..., None] * bias[None] + mask[:, None, None, :]
        e = torch.exp(p - p.amax(dim=-1, keepdim=True))
    r = e.sum(dim=-1, keepdim=True)
    if postnorm:
        return (torch.matmul(_bf16(e), v.float()) / r).to(q.dtype)
    a = _bf16(e * _bf16(1.0 / r)) if bf16chain else _bf16(e / r)
    return torch.matmul(a, v.float()).to(q.dtype)


def _check(q, k, v, bias, gate, mask) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the probe kernels run on a CUDA device; got a tensor on {q.device}")
    check_gated_inputs(q, k, v, bias, gate, mask)
    if q.dtype != torch.bfloat16 or not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("the probe kernels take contiguous bf16 [B, H, L, 64] q, k and v, "
                         f"got {q.dtype} with strides {q.stride()}")


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def quantize_kv(k: torch.Tensor, v: torch.Tensor):
    """Kernel path of ``quantize_kv_reference`` (the int8 probe's prologue),
    for contiguous bf16 [B, H, L, 64] k and v on the card: (kq, sk, vq in
    ``transpose_padded_reference``'s layout [B, H, 64, Lp], sv)."""
    if k.device.type != "cuda" or k.dtype != torch.bfloat16 or not (
            k.is_contiguous() and v.is_contiguous()) or k.shape != v.shape or k.shape[-1] != 64:
        raise ValueError("quantize_kv takes contiguous bf16 [B, H, L, 64] k and v on the card")
    from stutter_tpu_torch.ops._build import kernel_library

    B, H, L, d = k.shape
    Lp = padded_length(L)
    kq = torch.empty((B, H, L, d), dtype=torch.int8, device=k.device)
    sk = torch.empty((B, H, L), dtype=torch.float32, device=k.device)
    vqt = torch.empty((B, H, d, Lp), dtype=torch.int8, device=k.device)
    sv = torch.empty((B, H, d), dtype=torch.float32, device=k.device)
    with torch.cuda.device(k.device):
        rc = kernel_library().attn_int8_quantize_kv(
            k.data_ptr(), v.data_ptr(), kq.data_ptr(), sk.data_ptr(), vqt.data_ptr(),
            sv.data_ptr(), B * H, L, Lp, _stream(k))
    if rc != 0:
        raise RuntimeError(f"attn_int8_quantize_kv launch failed: CUDA error {rc}")
    return kq, sk, vqt, sv


def int8_attention_long(q, k, v, bias, gate, mask):
    """The int8 probe: its two kernels (``quantize_kv``, then the attention)
    for CUDA tensors, counted once in ``int8_attention_long.launches``; the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return int8_attention_long_reference(q, k, v, bias, gate, mask)
    _check(q, k, v, bias, gate, mask)
    kq, sk, vqt, sv = quantize_kv(k, v)
    from stutter_tpu_torch.ops._build import kernel_library

    B, H, L, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = kernel_library().attn_int8(
            q.data_ptr(), kq.data_ptr(), sk.data_ptr(), vqt.data_ptr(), sv.data_ptr(),
            bias.data_ptr(), gate.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, H, L, vqt.shape[-1], _stream(q))
    if rc != 0:
        raise RuntimeError(f"attn_int8 launch failed: CUDA error {rc}")
    int8_attention_long.launches += 1
    return out


int8_attention_long.launches = 0


def softmax_variant_attention(q, k, v, bias, gate, mask, postnorm: bool, bf16chain: bool):
    """One softmax variant: the templated kernel for CUDA tensors, counted in
    ``softmax_variant_attention.launches``; the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return softmax_variant_attention_reference(q, k, v, bias, gate, mask, postnorm,
                                                   bf16chain)
    _check(q, k, v, bias, gate, mask)
    from stutter_tpu_torch.ops._build import kernel_library

    B, H, L, _ = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = kernel_library().attn_softmax_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), gate.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, H, L, int(postnorm), int(bf16chain),
            _stream(q))
    if rc != 0:
        raise RuntimeError(f"attn_softmax_variant launch failed: CUDA error {rc}")
    softmax_variant_attention.launches += 1
    return out


softmax_variant_attention.launches = 0
