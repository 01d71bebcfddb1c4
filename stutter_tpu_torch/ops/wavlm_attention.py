"""WavLM's gated relative-position-bias attention core, forward and backward.

Counterpart of ``stutter_tpu/ops/wavlm_attention_pallas.py`` (both its short
and its long forward kernel) and ``stutter_tpu/ops/wavlm_attention_vjp.py``
(both backward kernels). For q pre-scaled by head_dim^-0.5::

    p   = q @ k^T + gate[..., None] * bias + mask[:, None, None, :]
    a   = softmax_rows(p)
    out = a @ v

and, given d(out) = do, with D = sum_d do * out::

    dp = a * (do @ v^T - D[..., None])
    dq = dp @ k      dk = dp^T @ q      dv = a^T @ do
    dgate = sum_j dp * bias            dbias = sum_b gate[..., None] * dp

``gated_relpos_attention`` launches the hand-written CUDA forward kernel
(``csrc/wavlm_attention.cu``) for CUDA tensors and counts each launch in
``gated_relpos_attention.launches``. ``device_path`` says which tiles a call
takes: bf16 the Hopper tiles of ``csrc/attention_tiles_sm90.cuh`` (``wgmma``
on 64-row query tiles; K, V, the bias plane and the key mask staged through
an asynchronous shared-memory ring, the rows of the last two as 16-byte
vectors where L and their addresses allow it, ``_attention.vector_bytes``;
the grid order by the bias plane's size, ``grid_order_for``), f32 the
scalar-FMA tiles of ``csrc/attention_tiles.cuh``.
``gated_relpos_attention_backward`` launches the backward kernels
(``csrc/wavlm_attention_bwd.cu``; bf16 on the same Hopper tiles: dq with
dgate and D, dk with dv, and dbias over groups of clips, ``clip_groups_for``,
the dq and dk+dv kernels in ``grid_order_for``'s order) and counts each
backward in ``gated_relpos_attention_backward.launches``. For CPU
tensors both run their plain PyTorch versions (``*_reference``), which the
tests and the on-card comparison also use; any other device raises.

``GatedRelPosAttentionFn`` is the differentiable core: its forward has the
kernel also write the per-row softmax statistics, and its backward feeds
them to the backward kernels. Extraction calls ``gated_relpos_attention``
under ``inference_mode`` and saves nothing.
"""

from __future__ import annotations

import torch

from stutter_tpu_torch.ops import _attention
from stutter_tpu_torch.ops._attention import (
    BF16_TILES,  # noqa: F401  (what device_path returns)
    DTYPE_CODES,
    F32_TILES,  # noqa: F401
    HEAD_DIM,
    check_qkv,
    empty_like_q,
    vector_bytes,
)

# The bf16 tiles' grid orders (csrc/attention_tiles_sm90.cuh, GridOrder).
QUERY_TILE_FASTEST, CLIP_FASTEST = 0, 1
# While the whole [H, L, L] bias plane stays in the 50 MB L2, the query tile
# goes fastest (the blocks in flight then read every head of a few clips,
# whole rows of the [B, L, H, 64] projections); above this size the clip
# goes fastest, so that the B blocks that read one slab of the plane run
# together and the slab comes from device memory once. PERF.md §6 has the
# sweep behind the size (planes of 1.6-10 MB, the 3-8 s buckets: query tile
# fastest 1-3 % faster; 24 MB at 12 s: level; 65 and 145 MB at 20 and 30 s:
# clip fastest 25 % faster).
CLIP_FASTEST_ABOVE_BYTES = 16 << 20
# The bf16 dbias kernel runs one block per (head, 64 x 64 tile, group of
# clips): at least this many blocks (two waves of two blocks an SM on the
# H100's 132 SMs), with at least DBIAS_MIN_CLIPS clips a group.
DBIAS_TARGET_BLOCKS = 4 * 132
DBIAS_MIN_CLIPS = 4


def _compute_dtype(q) -> torch.dtype:
    """The plain versions compute in f32, or in f64 for f64 inputs (gradcheck)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _scores(q, k, position_bias, gate, key_mask_bias):
    ct = _compute_dtype(q)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2))
    s = s + gate.to(ct)[..., None] * position_bias.to(ct)[None]
    return s + key_mask_bias.to(ct)[:, None, None, :]


def gated_relpos_attention_reference(q, k, v, position_bias, gate, key_mask_bias):
    """Plain version: scores, softmax and both products in f32, the
    [B, H, L, L] scores materialised; output in q's dtype."""
    a = torch.softmax(_scores(q, k, position_bias, gate, key_mask_bias), dim=-1)
    return torch.matmul(a, v.to(a.dtype)).to(q.dtype)


def attention_row_stats_reference(q, k, position_bias, gate, key_mask_bias):
    """[2, B, H, L] f32: each score row's max and the log of its sum of
    exp(score - max), as the forward kernel writes them for the backward.
    (Kept apart rather than as one log-sum-exp: a fully padded row scores
    -1e9 everywhere, where max + log(sum) rounds back to the max.)"""
    s = _scores(q, k, position_bias, gate, key_mask_bias)
    m = s.amax(dim=-1)
    logl = torch.log(torch.exp(s - m[..., None]).sum(dim=-1))
    return torch.stack([m, logl]).float()


def gated_relpos_attention_backward_reference(q, k, v, position_bias, gate,
                                              key_mask_bias, out, grad_out):
    """Plain backward (the math of ``wavlm_attention_vjp.py:12-26``): the
    softmax recomputed in f32; dp and a rounded to the input dtype before the
    three products, as the Pallas kernels round them; f32 accumulation.
    Returns (dq, dk, dv in q's dtype, dbias [H, L, L] f32, dgate [B, H, L] f32)."""
    dt, ct = q.dtype, _compute_dtype(q)
    a = torch.softmax(_scores(q, k, position_bias, gate, key_mask_bias), dim=-1)
    do = grad_out.to(dt).to(ct)
    dsum = (grad_out.to(ct) * out.to(ct)).sum(dim=-1, keepdim=True)
    dp = a * (torch.matmul(do, v.to(ct).transpose(-1, -2)) - dsum)
    dpc, ac = dp.to(dt).to(ct), a.to(dt).to(ct)
    dq = torch.matmul(dpc, k.to(ct)).to(dt)
    dk = torch.matmul(dpc.transpose(-1, -2), q.to(ct)).to(dt)
    dv = torch.matmul(ac.transpose(-1, -2), do).to(dt)
    dgate = (dp * position_bias.to(ct)[None]).sum(dim=-1)
    dbias = (gate.to(ct)[..., None] * dp).sum(dim=0)
    return dq, dk, dv, dbias, dgate


def device_path(q, k, v) -> str:
    """Which tiles these inputs launch (``_attention.device_path``); the
    gated kernels are built at head_dim 64 alone."""
    return _attention.device_path(q, k, v, (HEAD_DIM,))


def _check(q, k, v, position_bias, gate, key_mask_bias) -> None:
    device_path(q, k, v)
    B, H, L, _ = q.shape
    expect = {"position_bias": (position_bias, (H, L, L)),
              "gate": (gate, (B, H, L)), "key_mask_bias": (key_mask_bias, (B, L))}
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, found one on {t.device}")


def _check_stats(q, row_stats) -> None:
    B, H, L, _ = q.shape
    if (tuple(row_stats.shape) != (2, B, H, L) or row_stats.dtype != torch.float32
            or not row_stats.is_contiguous() or row_stats.device != q.device):
        raise ValueError(f"row_stats must be a contiguous float32 (2, {B}, {H}, {L}) on "
                         f"{q.device}, got {row_stats.dtype} {tuple(row_stats.shape)} "
                         f"on {row_stats.device}")


def _device_kind(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    return q.device.type


def grid_order_for(H: int, L: int) -> int:
    """The bf16 tiles' grid order for H heads of length L."""
    return CLIP_FASTEST if 4 * H * L * L > CLIP_FASTEST_ABOVE_BYTES else QUERY_TILE_FASTEST


def launch_tiles(q, k, v, position_bias, gate, key_mask_bias, row_stats, grid_order: int):
    """Launch the CUDA kernel on checked CUDA inputs with the given bf16
    grid order (read by the bf16 path only), uncounted.
    ``gated_relpos_attention`` calls it with ``grid_order_for``'s order;
    ``cli/flash_tiles_ab.py`` times the other one through it."""
    if q.device.type != "cuda":
        raise ValueError(f"launch_tiles launches a CUDA kernel; got a tensor on {q.device}")
    from stutter_tpu_torch.ops._build import kernel_library

    lib = kernel_library()
    out = empty_like_q(q)
    B, H, L, _ = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.wavlm_gated_relpos_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), position_bias.data_ptr(),
            gate.data_ptr(), key_mask_bias.data_ptr(), out.data_ptr(),
            None if row_stats is None else row_stats.data_ptr(),
            B, H, L, vector_bytes(position_bias, key_mask_bias), grid_order,
            q.stride(0), q.stride(1), q.stride(2), DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wavlm_gated_relpos_attention launch failed: CUDA error {rc}")
    return out


def gated_relpos_attention(q, k, v, position_bias, gate, key_mask_bias, row_stats=None):
    """q, k, v [B, H, L, d] (q pre-scaled; k and v with q's strides, the head
    dimension contiguous); position_bias [H, L, L] f32; gate [B, H, L] f32;
    key_mask_bias [B, L] f32 (0 or -1e9). Returns [B, H, L, d] in q's dtype,
    laid out like q. Given ``row_stats`` (a [2, B, H, L] f32 buffer), also
    writes each score row's max and log-sum into it for the backward."""
    if _device_kind(q) == "cpu":
        if row_stats is not None:
            _check_stats(q, row_stats)
            row_stats.copy_(attention_row_stats_reference(q, k, position_bias, gate,
                                                          key_mask_bias))
        return gated_relpos_attention_reference(q, k, v, position_bias, gate,
                                                key_mask_bias)
    _check(q, k, v, position_bias, gate, key_mask_bias)
    if row_stats is not None:
        _check_stats(q, row_stats)
    out = launch_tiles(q, k, v, position_bias, gate, key_mask_bias, row_stats,
                       grid_order_for(*q.shape[1:3]))
    gated_relpos_attention.launches += 1
    return out


gated_relpos_attention.launches = 0


def clip_groups_for(B: int, H: int, L: int) -> int:
    """How many groups of clips the bf16 dbias kernel sums apart (each group
    ``ceil(B / groups)`` clips in order, none empty): enough for
    ``DBIAS_TARGET_BLOCKS`` blocks of one (head, 64 x 64 tile, group), with at
    least ``DBIAS_MIN_CLIPS`` clips a group so that the ring runs ahead."""
    tiles = -(-L // 64)
    wanted = min(max(1, B // DBIAS_MIN_CLIPS), -(-DBIAS_TARGET_BLOCKS // (H * tiles * tiles)))
    per_group = -(-B // wanted)
    return -(-B // per_group)


def dbias_scratch_shape(H: int, L: int, clip_groups: int):
    """The [groups, H, L, L] f32 scratch of the groups' partial dbias planes,
    or None with one group (the kernel then writes dbias itself)."""
    return None if clip_groups == 1 else (clip_groups, H, L, L)


def launch_backward(q, k, v, position_bias, gate, key_mask_bias, out, do, row_stats,
                    grid_order: int, clip_groups: int):
    """Launch the backward kernels on checked CUDA inputs (``do`` laid out
    like q) with the given bf16 grid order and clip groups (read by the bf16
    path only), uncounted: (dq, dk, dv, dbias, dgate).
    ``gated_relpos_attention_backward`` calls it with ``grid_order_for``'s
    order and ``clip_groups_for``'s groups; ``cli/flash_tiles_ab.py`` runs
    the others through it."""
    if _device_kind(q) != "cuda":
        raise ValueError(f"launch_backward launches CUDA kernels; got a tensor on {q.device}")
    from stutter_tpu_torch.ops._build import kernel_library

    lib = kernel_library()
    B, H, L, _ = q.shape
    f32 = {"dtype": torch.float32, "device": q.device}
    dq, dk, dv = empty_like_q(q), empty_like_q(q), empty_like_q(q)
    dsum = torch.empty((B, H, L), **f32)  # D, written by the first kernel
    dgate = torch.empty((B, H, L), **f32)
    dbias = torch.empty((H, L, L), **f32)
    shape = dbias_scratch_shape(H, L, clip_groups)
    parts = None if shape is None or q.dtype != torch.bfloat16 else torch.empty(shape, **f32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.wavlm_gated_relpos_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), position_bias.data_ptr(),
            gate.data_ptr(), key_mask_bias.data_ptr(), do.data_ptr(), row_stats.data_ptr(),
            out.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dgate.data_ptr(), dbias.data_ptr(), None if parts is None else parts.data_ptr(),
            B, H, L, clip_groups,
            vector_bytes(position_bias, key_mask_bias, gate, row_stats, dsum), grid_order,
            q.stride(0), q.stride(1), q.stride(2), DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"wavlm_gated_relpos_attention_bwd launch failed: CUDA error {rc}")
    return dq, dk, dv, dbias, dgate


def gated_relpos_attention_backward(q, k, v, position_bias, gate, key_mask_bias, out,
                                    grad_out, row_stats=None):
    """The backward of ``gated_relpos_attention``: (dq, dk, dv [B, H, L, d] in
    q's dtype and laid out like q, dbias [H, L, L] f32, dgate [B, H, L] f32).
    On the card ``row_stats`` is the buffer the forward filled, and the
    kernels compute D themselves (from ``grad_out`` in q's dtype); the CPU
    path recomputes the softmax and ignores it."""
    if _device_kind(q) == "cpu":
        return gated_relpos_attention_backward_reference(
            q, k, v, position_bias, gate, key_mask_bias, out, grad_out)
    _check(q, k, v, position_bias, gate, key_mask_bias)
    if row_stats is None:
        raise ValueError("the backward kernels need the forward's row_stats")
    _check_stats(q, row_stats)
    for name, t in (("out", out), ("grad_out", grad_out)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, "
                             f"q is {tuple(q.shape)} on {q.device}")
    if out.dtype != q.dtype or out.stride() != q.stride():
        raise ValueError("out must be the forward's output, laid out like q")
    do = grad_out
    if do.dtype != q.dtype or do.stride() != q.stride():
        do = empty_like_q(q)
        do.copy_(grad_out)
    check_qkv(q, do, v, (HEAD_DIM,))  # the kernels read do with q's strides and alignment
    B, H, L, _ = q.shape
    grads = launch_backward(q, k, v, position_bias, gate, key_mask_bias, out, do, row_stats,
                            grid_order_for(H, L), clip_groups_for(B, H, L))
    gated_relpos_attention_backward.launches += 1
    return grads


gated_relpos_attention_backward.launches = 0


class GatedRelPosAttentionFn(torch.autograd.Function):
    """Differentiable gated relative-position-bias attention: the forward and
    backward wrappers above, gradients to q, k, v, position_bias and gate;
    key_mask_bias (derived from lengths) gets none, as in the JAX VJP."""

    @staticmethod
    def forward(ctx, q, k, v, position_bias, gate, key_mask_bias):
        B, H, L, _ = q.shape
        row_stats = None
        if q.device.type == "cuda":
            row_stats = torch.empty((2, B, H, L), dtype=torch.float32, device=q.device)
        out = gated_relpos_attention(q, k, v, position_bias, gate, key_mask_bias,
                                     row_stats)
        saved = [q, k, v, position_bias, gate, key_mask_bias, out]
        if row_stats is not None:
            saved.append(row_stats)
        ctx.save_for_backward(*saved)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, position_bias, gate, key_mask_bias, out, *stats = ctx.saved_tensors
        dq, dk, dv, dbias, dgate = gated_relpos_attention_backward(
            q, k, v, position_bias, gate, key_mask_bias, out, grad_out,
            stats[0] if stats else None)
        return dq, dk, dv, dbias.to(position_bias.dtype), dgate.to(gate.dtype), None


def gated_relpos_attention_diff(q, k, v, position_bias, gate, key_mask_bias):
    """The training path's attention core: ``GatedRelPosAttentionFn`` when a
    gradient is wanted, else the forward alone (no statistics, nothing saved)."""
    args = (q, k, v, position_bias, gate, key_mask_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args[:5]):
        return GatedRelPosAttentionFn.apply(*args)
    return gated_relpos_attention(*args)
