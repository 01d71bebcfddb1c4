"""The benchmark's frozen yardsticks: the card's peaks, the roofline bound,
the models' FLOP counts and each kernel's operations and bytes.

These are copies, kept here so that a later change to the program cannot
move the yardstick it is measured with. ``tests/test_yardstick.py`` holds
each one equal to the program's own count at today's shapes.

Peaks: one NVIDIA H100 SXM, dense, from NVIDIA's data sheet, at its full
700 W power limit.
"""

from __future__ import annotations

BF16_PEAK = 989e12    # FLOP/s, the tensor cores
F32_PEAK = 67e12      # FLOP/s, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HEAD_DIM = 64


def bound_s(flops: float, nbytes: float, peak: float = BF16_PEAK) -> float:
    """The least seconds the card could take: the larger of the operations
    over their peak rate and the bytes over the memory rate."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def conv_lengths(n_samples: int, kernels, strides) -> list[int]:
    """The frame count after each convolution of a stem without padding."""
    out = []
    for k, s in zip(kernels, strides):
        n_samples = (n_samples - k) // s + 1
        out.append(n_samples)
    return out


def wavlm_flops_parts(cfg: dict, n_samples: int) -> tuple[float, float]:
    """(encoder, stem) FLOPs (MACs x 2) of one WavLM forward over one clip
    of ``n_samples``. Encoder per token per layer: q, k, v, o 4 D^2,
    attention scores and values 2 L D, FFN 2 D F MACs; stem: each
    convolution's L_i C_out C_in k."""
    lens = conv_lengths(n_samples, cfg["conv_kernel"], cfg["conv_stride"])
    L, D, F = lens[-1], cfg["hidden_size"], cfg["intermediate_size"]
    enc = (4 * D * D + 2 * L * D + 2 * D * F) * L * cfg["num_hidden_layers"]
    stem, cin = 0, 1
    for n, cout, k in zip(lens, cfg["conv_dim"], cfg["conv_kernel"]):
        stem += n * cout * cin * k
        cin = cout
    return 2.0 * enc, 2.0 * stem


def wavlm_flops(cfg: dict, n_samples: int) -> float:
    """FLOPs of one WavLM forward over one clip, encoder and stem."""
    return sum(wavlm_flops_parts(cfg, n_samples))


def whisper_encoder_flops(cfg: dict) -> float:
    """FLOPs (MACs x 2) of one Whisper encoder forward over one 30 s window:
    the two-convolution stem over 3000 and 1500 frames, then per token per
    layer q, k, v, o 4 D^2, scores and values 2 L D, FFN 2 D F MACs."""
    D, F, L = cfg["d_model"], cfg["ffn_dim"], cfg["max_source_positions"]
    stem = 2 * L * 3 * cfg["num_mel_bins"] * D + L * 3 * D * D
    enc = (4 * D * D + 2 * L * D + 2 * D * F) * L * cfg["encoder_layers"]
    return 2.0 * (stem + enc)


def gated_attention_fwd(B: int, H: int, L: int, elem: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one gated relative-position attention call:
    q k^T and p v; q, k, v read and the output written once each in the
    activation dtype (``elem`` bytes), the [H, L, L] f32 bias, the [B, H, L]
    f32 gate and the [B, L] f32 key mask read once."""
    n = B * H * L * HEAD_DIM
    return 4.0 * n * L, 4.0 * n * elem + 4.0 * (H * L * L + B * H * L + B * L)


def gated_attention_bwd(B: int, H: int, L: int, elem: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one backward call: q k^T recomputed, then
    d_out v^T, dq, dk and dv, five products; q, k, v, out, d_out read and
    dq, dk, dv written in the activation dtype; the bias read and its
    gradient written, [H, L, L] f32 each; gate, its gradient, the row
    statistics and D, [B, H, L] f32 each; the key mask."""
    n = B * H * L * HEAD_DIM
    return (10.0 * n * L,
            8.0 * n * elem + 4.0 * (2 * H * L * L + 4 * B * H * L + B * L))


def flash_mha_fwd(B: int, H: int, L: int, elem: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one unmasked self-attention call: q k^T and
    p v; q, k, v read and the output written once each."""
    n = B * H * L * HEAD_DIM
    return 4.0 * n * L, 4.0 * n * elem
