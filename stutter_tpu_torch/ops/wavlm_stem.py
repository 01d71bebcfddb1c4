"""WavLM-Large's whole conv stem in one call: the hand-written CUDA kernels and
their plain version.

Counterpart of ``stutter_tpu/ops/wavlm_stem_pallas.py`` (``wavlm_fused_stem``,
kernel ``_stem_kernel``). Raw wave [B, T] -> the 7-conv layer-norm stem ->
frames [B, L, C] bf16, UNMASKED: a caller with padded clips zeroes the frames
at or past each clip's true length itself (for the per-frame layer-norm stem
that equals the plain stem's per-layer masking).

Every layer computes, with its rounding points (``_ln_gelu`` in the JAX
package):
- the conv, accumulated in f32 and rounded to bf16 (layer 0 reads the wave
  cast to bf16);
- the conv bias, rounded to bf16 and added in bf16;
- the layer norm over channels, statistics in f32 and two-pass (the mean,
  then the mean of (x - mean)^2), eps 1e-5, the affine in f32, cast to bf16;
- the tanh GELU of that bf16 value, rounded to bf16.

``pack_stem_weights`` lays the 7 ``_ConvLayer``s out once as the kernels read
them, all in one bf16 buffer of [16 + sum_i k_i C, C] rows, and a [7, 3, C]
f32 table of (conv bias, LN scale, LN bias): layer 0's [C_out, 1, 10] weight
as a tap-major [16, C_out] matrix (taps zero-padded to 16 rows); each conv
layer's [C_out, C_in, k] weight, in its k * C_in rows, as the wgmma tiles of
``csrc/wavlm_stem.cu``: for each pass of ``min(C, 256)`` output channels and
each chunk of 64 of the tap-major contraction (index j * C_in + c), a
K-major [channels, 64] tile whose 16-byte groups are swizzled (group g of
row n stored at g ^ (n % 8): the 128-byte swizzle that wgmma reads), so that
a tile is one contiguous copy. ``WavLMModel`` caches the pack per model and
dtype.

``wavlm_fused_stem`` launches ``csrc/wavlm_stem.cu`` for CUDA tensors (seven
kernel launches, one per layer, counted once per call in
``wavlm_fused_stem.launches``); for CPU tensors it runs
``wavlm_fused_stem_reference``, the plain version, which the tests and the
on-card comparison also use. The plain version runs each conv in f32 under
``no_tf32`` on bf16-valued inputs, so its products are exact and its sums
f32, and rounds where the kernel rounds.

``fused_stem_applicable`` is the JAX package's gate, kept as it is so that
both packages take the fused path on the same inputs: the layer-norm stem of
the standard 7-layer geometry, equal widths that are a multiple of 128,
plain weights, and a bucket length of whole 16-frame blocks with no dangling
samples (``n_samples == L * 320 + 80``), which the Hopper kernel does not
need. The kernel itself is built for 512 channels, the width of every
WavLM and wav2vec2 stem; its wrapper raises for another, and
``fused_stem_supported`` tells a caller to keep the plain stem then.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stutter_tpu_torch.models.common import gelu, layer_norm
from stutter_tpu_torch.ops.precision import no_tf32

# the standard wav2vec2-family 7-layer stem (receptive field 400, stride 320)
_KERNELS = (10, 3, 3, 3, 3, 2, 2)
_STRIDES = (5, 2, 2, 2, 2, 2, 2)
_BLOCK_FRAMES = 16  # the JAX kernel's output frames per grid step
CHANNELS = 512  # the width the Hopper kernel is built for
_LAYER0_ROWS = 16  # layer 0's 10 taps, zero-padded to one m16n8k16 depth
_TILE_K = 64  # the conv tiles' contraction: one 128-byte row
_TILE_N = 256  # the conv tiles' output channels: one pass of the kernel
CONV_TILE_FRAMES = 128  # output frames a tile of the conv kernels
CONV_CLUSTER = 2  # CTAs a cluster along the frames, sharing each weight tile


def stem_layer_lengths(T: int) -> list[int]:
    """Each layer's output frame count for T samples."""
    lengths, L = [], T
    for k, s in zip(_KERNELS, _STRIDES):
        L = (L - k) // s + 1
        lengths.append(L)
    return lengths


def conv_plan(T: int) -> list[tuple[int, int, int]]:
    """The CUDA conv kernels' tiles along one clip, layer by layer (1-6):
    (input frames, output frames, tiles). A tile is ``CONV_TILE_FRAMES``
    output frames; a cluster of ``CONV_CLUSTER`` CTAs takes that many
    adjacent tiles at a time, so the count is rounded up to whole clusters,
    and a tile whose frames all lie past the clip's end stores nothing."""
    lengths = stem_layer_lengths(T)
    plan = []
    for T_in, T_out in zip(lengths[:-1], lengths[1:]):
        tiles = -(-T_out // CONV_TILE_FRAMES)
        plan.append((T_in, T_out, -(-tiles // CONV_CLUSTER) * CONV_CLUSTER))
    return plan


def stem_frames_for_samples(T: int) -> int:
    """Final frame count of the (400, 320) stem floor chain."""
    return stem_layer_lengths(T)[-1]


def fused_stem_applicable(cfg, n_samples: int, conv_layers) -> bool:
    """True when the fused stem reproduces ``ConvFeatureEncoder`` exactly:
    layer-norm stem, standard geometry, equal widths that are a multiple of
    128, plain (unquantized) weights, and a bucket length the 16-frame
    blocking tiles."""
    if getattr(cfg, "feat_extract_norm", None) != "layer":
        return False
    if tuple(cfg.conv_kernel) != _KERNELS or tuple(cfg.conv_stride) != _STRIDES:
        return False
    if any(d != cfg.conv_dim[0] for d in cfg.conv_dim) or cfg.conv_dim[0] % 128:
        return False
    if any(not isinstance(layer.weight, torch.Tensor) for layer in conv_layers):
        return False  # quantized stem weights stay on the plain path
    L = stem_frames_for_samples(n_samples)
    return L >= _BLOCK_FRAMES and L % _BLOCK_FRAMES == 0 and n_samples == L * 320 + 80


def fused_stem_supported(cfg, device: torch.device) -> bool:
    """Whether ``wavlm_fused_stem`` can run this stem width on ``device``:
    the plain version (CPU) takes any width the gate passes, the kernel only
    ``CHANNELS``; a caller keeps the plain stem where this is False."""
    return device.type == "cpu" or cfg.conv_dim[0] == CHANNELS


def _swizzled_groups(rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices ([rows, 1] rows, [rows, 8] groups) of the 16-byte group of a
    128-byte row that lands at each position under the 128-byte swizzle (an
    involution: g ^ (row % 8))."""
    row = torch.arange(rows, device=device)[:, None]
    return row, torch.arange(8, device=device)[None, :] ^ (row % 8)


def conv_tiles(w: torch.Tensor) -> torch.Tensor:
    """A conv layer's [C_out, C_in, k] weight -> its wgmma tiles as k * C_in
    rows of C_out: [passes][chunks][n][64] with each row's 16-byte groups
    swizzled."""
    C, c_in, k = w.shape
    nb = min(C, _TILE_N)
    mat = w.permute(0, 2, 1).reshape(C, k * c_in)  # [n, j * C_in + c]
    tiles = mat.view(C // nb, nb, k * c_in // _TILE_K, 8, 8).permute(0, 2, 1, 3, 4)
    tiles = tiles[(slice(None), slice(None), *_swizzled_groups(nb, w.device))]
    return tiles.reshape(k * c_in, C)


def conv_from_tiles(block: torch.Tensor, k: int) -> torch.Tensor:
    """``conv_tiles``'s inverse: k * C_in rows of C_out -> [C_out, C_in, k]."""
    rows, C = block.shape
    c_in, nb = rows // k, min(C, _TILE_N)
    tiles = block.reshape(C // nb, rows // _TILE_K, nb, 8, 8)
    tiles = tiles[(slice(None), slice(None), *_swizzled_groups(nb, block.device))]
    return tiles.permute(0, 2, 1, 3, 4).reshape(C, k, c_in).permute(0, 2, 1)


def pack_stem_weights(conv_layers) -> tuple[torch.Tensor, torch.Tensor]:
    """The 7 ``_ConvLayer``s -> (weights bf16 [16 + 4 * 3C + 2 * 2C, C]:
    layer 0's tap-major [16, C] matrix, then each conv layer's wgmma tiles in
    its k * C rows (see the module's docstring); table f32 [7, 3, C]: conv
    bias, LN scale, LN bias)."""
    mats, rows = [], []
    for i, layer in enumerate(conv_layers):
        w = layer.weight.detach().to(torch.bfloat16)  # [C_out, C_in, k]
        C, c_in, k = w.shape
        if i == 0:
            mat = w.permute(2, 1, 0).reshape(k * c_in, C)
            mat = F.pad(mat, (0, 0, 0, _LAYER0_ROWS - mat.shape[0]))
        else:
            mat = conv_tiles(w)
        mats.append(mat)
        bias = (layer.bias.detach().float() if layer.bias is not None
                else torch.zeros(C, device=w.device))
        rows.append(torch.stack([bias, layer.norm_scale.detach().float(),
                                 layer.norm_bias.detach().float()]))
    return torch.cat(mats).contiguous(), torch.stack(rows).contiguous()


def _layer_weights(weights: torch.Tensor):
    """Split the packed buffer into each layer's contiguous [C_out, C_in, k]
    f32 weight (as ``ConvFeatureEncoder`` holds it, so that the convs sum in
    its order)."""
    C = weights.shape[1]
    out, row = [], 0
    for i, k in enumerate(_KERNELS):
        if i == 0:  # layer 0's padding rows dropped
            w = weights[:k].view(k, 1, C).permute(2, 1, 0)
            row = _LAYER0_ROWS
        else:
            w = conv_from_tiles(weights[row:row + k * C], k)
            row += k * C
        out.append(w.float().contiguous())
    return out


def wavlm_fused_stem_reference(waveform: torch.Tensor, weights: torch.Tensor,
                               table: torch.Tensor) -> torch.Tensor:
    """Plain version: waveform [B, T] (f32 or bf16), the packed weights and
    table -> unmasked frames [B, L, C] bf16."""
    bf16 = torch.bfloat16
    x = waveform.to(bf16)[:, None, :]  # [B, 1, T]
    with no_tf32():
        for i, w in enumerate(_layer_weights(weights)):
            h = F.conv1d(x.float(), w, stride=_STRIDES[i]).to(bf16)
            h = h + table[i, 0].to(bf16)[None, :, None]
            x = gelu(layer_norm(h, table[i, 1], table[i, 2], 1e-5, dim=1))
    return x.transpose(1, 2).contiguous()


def _check(waveform, weights, table) -> None:
    C = CHANNELS
    if weights.dim() != 2 or weights.shape[1] != C:
        raise ValueError(f"the kernel is built for {C} channels, got weights "
                         f"{tuple(weights.shape)}")
    n_rows = _LAYER0_ROWS + sum(k * C for k in _KERNELS[1:])
    if waveform.dim() != 2 or waveform.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"waveform must be float32 or bfloat16 [B, T], got "
                         f"{waveform.dtype} {tuple(waveform.shape)}")
    if waveform.shape[1] < 400:
        raise ValueError(f"the stem needs at least 400 samples, got {waveform.shape[1]}")
    if not 0 < waveform.shape[0] <= 65535:
        raise ValueError(f"batch {waveform.shape[0]} outside the kernel's grid")
    for name, t, shape, dtype in (("weights", weights, (n_rows, C), torch.bfloat16),
                                  ("table", table, (7, 3, C), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
        if t.device != waveform.device:
            raise ValueError(f"{name} is on {t.device}, the waveform on {waveform.device}")


def wavlm_fused_stem(waveform: torch.Tensor, weights: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """waveform [B, T] f32 or bf16 (frontend-normalised), weights and table
    from ``pack_stem_weights`` -> unmasked frames [B, L, 512] bf16."""
    if waveform.device.type == "cpu":
        return wavlm_fused_stem_reference(waveform, weights, table)
    if waveform.device.type != "cuda":
        raise ValueError(f"no kernel for device {waveform.device}")
    _check(waveform, weights, table)
    from stutter_tpu_torch.ops._build import kernel_library

    lib = kernel_library()
    wave = waveform.float().contiguous()
    B, T = wave.shape
    lengths = stem_layer_lengths(T)
    # ping-pong buffers for layers 0..5; layer 6 writes the output
    opts = dict(dtype=torch.bfloat16, device=wave.device)
    buf0 = torch.empty((B, lengths[0], CHANNELS), **opts)
    buf1 = torch.empty((B, lengths[1], CHANNELS), **opts)
    out = torch.empty((B, lengths[-1], CHANNELS), **opts)
    with torch.cuda.device(wave.device):
        stream = torch.cuda.current_stream(wave.device).cuda_stream
        rc = lib.wavlm_fused_stem(wave.data_ptr(), weights.data_ptr(), table.data_ptr(),
                                  buf0.data_ptr(), buf1.data_ptr(), out.data_ptr(), B, T,
                                  stream)
    if rc != 0:
        raise RuntimeError(f"wavlm_fused_stem launch failed: CUDA error {rc}")
    wavlm_fused_stem.launches += 1
    return out


wavlm_fused_stem.launches = 0
