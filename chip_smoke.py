#!/usr/bin/env python3
"""Run the PyTorch port's WavLM-Large and Whisper-large extraction (fidelity,
fast, turbo), WavLM's long-bucket escape hatch, the two attention probes,
the fused WavLM stem and WavLM-Large fine-tuning on one NVIDIA GPU and check
them.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, one line each on stdout ([time] lines give each phase's seconds):
1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from stutter_tpu_torch/csrc (nvcc, sm_90a,
   one process per source);
3. kernel: the WavLM attention kernel against its plain PyTorch version on
   the card, at the extraction path's shapes and a ragged length, with masks
   that cut clips short: errors against stated tolerances, median times;
3b. attn_bwd: the WavLM attention backward kernels (and the forward's row
   statistics) against the plain backward, bf16 and f32, at the fine-tune
   CLI's 3 s and 10 s batches and a ragged L = 1008, with a fully padded
   clip: per gradient the max-abs error over the plain result's max and the
   cosine distance, median times;
4. logmel: the Whisper log-mel kernel against its plain version at 16 x 30 s
   (80 and 128 mels; silent, quiet and zero-padded clips among them);
5. mha: the Whisper encoder's flash-attention kernel against its plain
   version at 16 x 20 x 1500 x 64 in bf16 and f32, with key padding and at a
   ragged length; scaled_dot_product_attention timed beside it;
5a. mha_bias: the materialised-bias flash kernel (WavLM's escape hatch)
   against its plain version at 12 x 16 x 1504 x 64 and 19 x 16 x 1008 x 64
   in bf16 with keys masked, and f32 at a ragged length;
   scaled_dot_product_attention with the same bias timed beside it;
5b. probe_kernels: the int8 probe's kernels (int8 k and v and their scales
   bit-equal to the plain version's) and the four softmax variants against
   their plain versions at 25 x 16 x 1504 x 64 and a ragged length;
5c. probes: cli.attn_int8_probe and cli.attn_softmax_variants_probe at
   their defaults, in-process: their JSON, fidelity against f32, launches;
5d. stem: the fused WavLM stem kernels against their plain version and the
   plain ConvFeatureEncoder (cuDNN) at 128 x 3 s and 12 x 30 s, with ragged
   lengths, a silent clip and a clip of 4 frames;
6. slice: a synthetic 16 kHz corpus through ExtractionPipeline.run with
   WavLM-Large (random weights, seed 0) in the fast preset; checks the store,
   the checkpoints, that every attention call went through the kernel, and
   that a resumed run skips finished rows;
7. path: one 3 s bucket batch through WavLMModel.encode with the kernel and
   with the plain attention, in the fast and the fidelity preset;
7a. long_slice: clips of the 3 s, 20 s and 30 s buckets through
   ExtractionPipeline.run with long_attention "gated" and
   "materialized_bias": exact launch counts of both kernels, the store, and
   the pooled distance between the two runs;
7b. turbo_slice: the slice again in turbo (6 int8 GEMMs per layer and
   batch), then turbo's pooled distance from the f32 path on one batch;
8. throughput: WavLM extraction's audio-seconds per second over 1280 clips
   of 2-3 s, after a warm batch, and one batch's device time, fast and turbo;
8b. stem_ab: cli.stem_fused_ab at its defaults (turbo) and in fast: the stem
   and the encode with and without the fused stem, fidelity, launches;
9. whisper_slice: a synthetic corpus through a default-constructed
   ExtractionPipeline with Whisper-large (random weights, seed 0, fast):
   the store, the checkpoints, one log-mel launch per batch and 32 attention
   launches per batch, and resume;
10. whisper_path: one 16 x 30 s batch through the kernel path and the plain
   path (plain log-mel and attention), in both presets;
10b. whisper_turbo_slice: the Whisper slice in turbo (5 int8 GEMMs per
   encoder layer and batch, none in the decoder) and turbo's distance from
   the f32 path on the 16 x 30 s batch;
11. whisper_throughput: 64 clips of 2-3 s in batches of 16, after a warm
   batch: clips/s, audio-s/s, one batch's device time, fast and turbo;
12. finetune_path: one fixed WavLM-Large training step at 8 x 3 s through
   the kernels and through the plain attention, bf16 and f32: the loss and
   the gradient cosine distance per group (encoder, layer weights, head);
13. finetune: stutter_tpu_torch.cli.finetune.main on a synthetic labeled
   corpus (128 clips of 2-3 s and 6 of 8-10 s to train on) at WavLM-Large:
   2 epochs with checkpoints, a --resume run for a third, a --grad_accum 2
   run; losses, parameters, launch counts (per-layer remat: 2 forwards and
   1 backward per layer per microbatch, 1 forward per eval batch), resume,
   outputs, ms per update, training audio-s/s, peak memory.
Each extraction, probe, stem A/B and fine-tune path is driven with every kernel's
launch count (and the int8 GEMM count) set to 0 just before it and read just
after. Then one JSON line with the kernels' numbers (time, plain time,
bound, library time, launches on their path) and, last, the device line.
Any failed check exits non-zero; with no CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# tolerances of the kernel against its plain version (which computes in f32
# and rounds once to the input dtype)
BF16_MAX_ABS = 2e-2  # one bf16 ulp at |out| < 4, where these outputs lie
BF16_COSINE = 1e-5
F32_MAX_ABS = 1e-5   # f32 sums taken in another order
F32_COSINE = 1e-9
# pooled embeddings, kernel path against plain-attention path, every layer
FAST_POOLED_COSINE = 1e-4
FIDELITY_POOLED_COSINE = 1e-6
# the log-mel kernel after the epilogue: the JAX package's bar for its kernel
LOGMEL_MAX_ABS = 1e-4
# Whisper's decoder columns in the fast preset: the one bf16 decoder step
# moves by ~1.6e-4 for any change of its encoder input, the plain path's own
# distance from the f32 path included (measured on the H100), so the fast
# bar there is 5e-4, under the repo's 1e-3; the encoder columns keep 1e-4
WHISPER_FAST_DECODER_COSINE = 5e-4
# the attention backward against the plain backward, per gradient (dq, dk,
# dv, dbias, dgate): max-abs error over the plain result's max, and cosine
# distance. bf16: dq, dk and dv are rounded once to bf16 in both (~4e-3 of
# an element), and dp is rounded to bf16 before the products, where a
# last-bit difference in the recomputed f32 dp can flip that rounding.
# f32: the probabilities come from exp((s - max) - log sum) against the
# plain softmax's division, and the sums run in another order.
BWD_BF16_REL, BWD_BF16_COSINE = 2e-2, 1e-4
BWD_F32_REL, BWD_F32_COSINE = 1e-4, 1e-8
# the forward's row statistics: the max of scores up to -1e9 (f32 spacing
# 64 there) and a log-sum of at most log(L)
BWD_STATS_MAX_ABS = 1e-3
# one training step through the kernels against the same step through the
# plain attention (autograd of the plain forward), WavLM-Large, 8 x 3 s: the
# loss's relative difference and the gradient cosine distance per group.
# bf16: every activation is rounded to bf16 in both, and the kernels round
# dp and the probabilities before their products where autograd keeps f32;
# the pooled states then differ by ~5e-6 in cosine (~3e-3 per element), and
# random-init logits are large (loss ~3.9 over 4 classes), so the loss moves
# by ~1e-3 of itself (8.2e-4 measured on the H100): its bar is 5e-3.
# f32: the same math, summed in another order.
FT_BF16_LOSS_REL, FT_BF16_GRAD_COSINE = 5e-3, 1e-3
FT_F32_LOSS_REL, FT_F32_GRAD_COSINE = 1e-5, 1e-8


# the int8 probe's kernels against their plain version: the int8 operands
# are bit-equal, but the f32 softmax sums in another order, so a probability
# on a round-half boundary of round(a * 127) can move one int8 step (one
# step of a v column, |v| / 127 ~ 1e-2 here). Measured on the H100:
# max-abs 1.1e-2, cosine 2.6e-5 at 25 x 16 x 1504 x 64.
INT8_MAX_ABS, INT8_COSINE = 5e-2, 2e-4
# the softmax variants against their plain version, max-abs a bf16 step of
# an output under 4 and cosine distance: A and C take the plain version's
# roundings with sums in another order (measured <= 3e-7); B and D take one
# online pass and round e relative to the running max, not the final one
# (measured <= 4.7e-6)
VARIANT_MAX_ABS = 2e-2
VARIANT_COSINE = {"A_incumbent": 1e-5, "B_postnorm": 5e-5, "C_bf16chain": 1e-5,
                  "D_both": 5e-5}
# the probes' outputs against f32 (their own fidelity), except int8's (its
# fixed 127 scale rounds diffuse rows' probabilities to 0: ~0.1-0.4 by design)
PROBE_F32_COSINE = 1e-3

# the card's peaks for the bounds (H100 SXM, dense)
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12      # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
# the fused stem against its plain version, and the kernel path's end-masked
# frames against the plain ConvFeatureEncoder: the JAX test's bars
# (tests/test_stem_pallas.py:98-102). Both share the rounding points (conv ->
# bf16, bias in bf16, f32 statistics, tanh GELU on bf16) but sum in another
# order, and one flipped bf16 rounding propagates through seven layer norms.
STEM_COSINE, STEM_NRMSE = 5e-4, 0.03
# pooled embeddings of the fused-stem encode against the f32 path: the repo's
# bar in fast, the JAX turbo tests' in turbo (tests/test_quant.py:153,184);
# and no farther than 1.25x the plain-stem path's own distance (the criterion
# of tests/test_stem_pallas.py:96-98, with a floor of 5e-5, under which a
# flipped rounding in either stem moves the ratio by more than 25 %)
STEM_AB_FAST_COSINE, TURBO_COSINE = 1e-3, 2e-2
STEM_AB_RATIO, STEM_AB_FLOOR = 1.25, 5e-5


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cosine_distance(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(1.0 - (a @ b) / (a.norm() * b.norm()))


_CORPORA: dict[Path, float] = {}  # corpora written in this run: their audio seconds


def write_corpus(root: Path, n_per_split: dict, dur_range, seed: int,
                 long_per_split: dict | None = None, long_range=(8.2, 9.8)) -> float:
    """KSF layout: wav/{split}_{i}.wav at 16 kHz plus lab/{split}.csv, clips
    of ``dur_range`` seconds (or ``dur_range[split]``, given a dict), with
    ``long_per_split[split]`` more clips of ``long_range`` seconds. Returns
    the total audio seconds; a corpus already written at ``root`` is reused."""
    import numpy as np

    if root in _CORPORA:
        return _CORPORA[root]

    from stutter_tpu_torch.audio.wavio import write_wav

    rng = np.random.RandomState(seed)
    (root / "wav").mkdir(parents=True)
    (root / "lab").mkdir()
    total = 0.0
    labels = ("no_disfluency", "block", "prolongation", "sound_repetition")
    for split, n in n_per_split.items():
        rows = []
        n_long = (long_per_split or {}).get(split, 0)
        for i in range(n + n_long):
            name = f"{split}_{i:04d}.wav"
            short = dur_range[split] if isinstance(dur_range, dict) else dur_range
            seconds = rng.uniform(*(short if i < n else long_range))
            t = np.arange(int(seconds * 16000)) / 16000
            f0 = rng.uniform(100, 600)
            x = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(len(t))
            write_wav(str(root / "wav" / name), x / max(1.0, np.abs(x).max() * 1.05), 16000)
            rows.append((name, labels[rng.randint(len(labels))]))
            total += len(t) / 16000
        with open(root / "lab" / f"{split}.csv", "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(("filename", "label"))
            w.writerows(rows)
    _CORPORA[root] = total
    return total


def phase_kernel(torch, attn):
    """Kernel against its plain version; returns (worst max-abs error, the
    numbers at the 3 s bf16 shape). No single PyTorch call computes the
    gated bias (gate * bias formed per row in the kernel), so no library
    time."""
    cases = [  # (B, H, L, dtype, layout): the main path passes [B, L, H, d] views
        (128, 16, 160, torch.bfloat16, "blhd"),   # 3 s bucket, fast preset
        (12, 16, 1504, torch.bfloat16, "blhd"),   # 30 s bucket, fast preset
        (128, 16, 160, torch.float32, "blhd"),    # 3 s bucket, fidelity preset
        (12, 16, 1504, torch.float32, "blhd"),    # 30 s bucket, fidelity preset
        (4, 16, 160, torch.float32, "blhd"),
        (5, 16, 37, torch.bfloat16, "bhld"),      # ragged L, contiguous
        (5, 16, 37, torch.float32, "bhld"),
    ]
    g = torch.Generator(device="cuda").manual_seed(0)
    worst_abs, headline = 0.0, None
    for B, H, L, dtype, layout in cases:
        def make():
            shape = (B, L, H, 64) if layout == "blhd" else (B, H, L, 64)
            t = (torch.randn(shape, device="cuda", generator=g) * 0.5).to(dtype)
            return t.transpose(1, 2) if layout == "blhd" else t
        q, k, v = make(), make(), make()
        bias = torch.randn(H, L, L, device="cuda", generator=g)
        gate = torch.rand(B, H, L, device="cuda", generator=g) * 2
        lengths = torch.randint(1, L + 1, (B,), device="cuda", generator=g)
        lengths[0], lengths[-1] = L, 0  # one full clip, one all-padding row
        mask = torch.where(torch.arange(L, device="cuda")[None] < lengths[:, None],
                           0.0, -1e9).float().contiguous()
        args = (q, k, v, bias, gate, mask)
        out = attn.gated_relpos_attention(*args)
        ref = attn.gated_relpos_attention_reference(*args)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == dtype and out.stride() == q.stride(),
              f"kernel output {out.dtype} {tuple(out.shape)} {out.stride()}")
        check(bool(torch.isfinite(out).all()), "kernel output has non-finite values")
        max_abs = float((out.float() - ref.float()).abs().max())
        cos = cosine_distance(out.float(), ref.float())
        tol_abs, tol_cos = ((BF16_MAX_ABS, BF16_COSINE) if dtype == torch.bfloat16
                            else (F32_MAX_ABS, F32_COSINE))
        ms, plain_ms = time_turns(torch, lambda: attn.gated_relpos_attention(*args),
                                 lambda: attn.gated_relpos_attention_reference(*args))
        # q k^T and p v; q, k, v and out once each, bias, gate, mask
        n = B * H * L * 64
        nbytes = 4 * n * q.element_size() + 4 * (H * L * L + B * H * L + B * L)
        numbers = timing(ms, plain_ms, *bound(4 * n * L, nbytes, peak_flops(torch, dtype)))
        say("kernel", shape=f"{B}x{H}x{L}x64", dtype=str(dtype).split(".")[-1],
            layout=layout, max_abs_err=f"{max_abs:.3e}", max_abs_tol=tol_abs,
            cosine_dist=f"{cos:.3e}", cosine_tol=tol_cos, **shown(numbers))
        check(max_abs <= tol_abs and cos <= tol_cos,
              f"kernel disagrees with its plain version at {B}x{H}x{L} {dtype}")
        worst_abs = max(worst_abs, max_abs)
        headline = headline or numbers
    return worst_abs, headline


def timing(ms, plain_ms, bound_ms, bound_by, library_ms=None) -> dict:
    """A kernel's numbers for the JSON line (library_ms: one PyTorch call
    that computes the same function, where there is one)."""
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def shown(numbers: dict) -> dict:
    """A kernel's numbers as a phase line prints them."""
    return {k: v if isinstance(v, str) or v is None else f"{v:.4f}"
            for k, v in numbers.items()}


def peak_flops(torch, dtype) -> float:
    """bf16 runs on the tensor cores; the f32 kernels are scalar FMAs."""
    return BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS


def attention_inputs(torch, g, B, H, L, dtype, lengths):
    """q, k, v as [B, L, H, 64] projections viewed [B, H, L, 64] (as the
    model passes them), bias, gate and the key mask of `lengths`."""
    def make():
        return (torch.randn(B, L, H, 64, device="cuda", generator=g) * 0.5).to(dtype) \
            .transpose(1, 2)
    q, k, v = make(), make(), make()
    bias = torch.randn(H, L, L, device="cuda", generator=g)
    gate = torch.rand(B, H, L, device="cuda", generator=g) * 2
    mask = torch.where(torch.arange(L, device="cuda")[None] < lengths[:, None],
                       0.0, -1e9).float().contiguous()
    return q, k, v, bias, gate, mask


def phase_attn_bwd(torch, attn, card: str):
    """Backward kernels against the plain backward; returns (worst max-abs
    error, the worst of it relative to the plain result's max, the numbers
    at the CLI's 3 s batch in bf16)."""
    cases = [  # (B, H, L): the CLI's batch 32 at 3 s, its 10 s bucket, a ragged long length
        (32, 16, 160), (9, 16, 512), (4, 16, 1008)]
    g = torch.Generator(device="cuda").manual_seed(7)
    worst_abs, worst, headline = 0.0, 0.0, None
    for B, H, L in cases:
        for dtype in (torch.bfloat16, torch.float32):
            lengths = torch.randint(1, L + 1, (B,), device="cuda", generator=g)
            lengths[0], lengths[-1] = L, 0  # one full clip, one fully padded clip
            args = attention_inputs(torch, g, B, H, L, dtype, lengths)
            stats = torch.empty(2, B, H, L, device="cuda")
            out = attn.gated_relpos_attention(*args, stats)
            do = (torch.randn(B, L, H, 64, device="cuda", generator=g) * 0.5).to(dtype) \
                .transpose(1, 2)
            got = attn.gated_relpos_attention_backward(*args, out, do, stats)
            ref = attn.gated_relpos_attention_backward_reference(*args, out, do)
            ref_stats = attn.attention_row_stats_reference(*args[:2], *args[3:])
            torch.cuda.synchronize()
            stats_err = float((stats - ref_stats).abs().max())
            tol_rel, tol_cos = ((BWD_BF16_REL, BWD_BF16_COSINE) if dtype == torch.bfloat16
                                else (BWD_F32_REL, BWD_F32_COSINE))
            fields = {}
            for name, a, b in zip(("dq", "dk", "dv", "dbias", "dgate"), got, ref):
                check(a.shape == b.shape and a.dtype == b.dtype,
                      f"{name}: {a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
                check(bool(torch.isfinite(a).all()), f"{name} has non-finite values")
                max_abs = float((a.float() - b.float()).abs().max())
                rel = max_abs / float(b.float().abs().max())
                cos = cosine_distance(a.float(), b.float())
                fields[name] = f"{rel:.2e}/{cos:.2e}"
                check(rel <= tol_rel and cos <= tol_cos,
                      f"backward {name} disagrees at {B}x{H}x{L} {dtype}: "
                      f"rel max-abs {rel:.3e}, cosine {cos:.3e}")
                worst, worst_abs = max(worst, rel), max(worst_abs, max_abs)
            check(stats_err <= BWD_STATS_MAX_ABS, f"row statistics differ by {stats_err:.3e}")
            ms, plain_ms = time_turns(
                torch, lambda: attn.gated_relpos_attention_backward(*args, out, do, stats),
                lambda: attn.gated_relpos_attention_backward_reference(*args, out, do))
            # reads q, k, v, do, out, bias, gate, mask, the row statistics;
            # writes dq, dk, dv, dbias, dgate; recomputes q k^T, then do v^T,
            # dq, dk and dv: five products of 2 B H L^2 64 operations
            n = B * H * L * 64
            nbytes = 8 * n * out.element_size() + 4 * (2 * H * L * L + 4 * B * H * L + B * L)
            numbers = timing(ms, plain_ms,
                             *bound(10 * n * L, nbytes, peak_flops(torch, dtype)))
            say("attn_bwd", shape=f"{B}x{H}x{L}x64", dtype=str(dtype).split(".")[-1],
                **{f"{k}_rel_cos": v for k, v in fields.items()},
                rel_tol=tol_rel, cosine_tol=tol_cos, stats_max_abs=f"{stats_err:.2e}",
                **shown(numbers), card=f'"{card}"')
            headline = headline or numbers
    return worst_abs, worst, headline


def time_turns(torch, *fns, runs: int = 20):
    """Median ms of each function, timed per launch with CUDA events, in turns."""
    for _ in range(3):
        for fn in fns:
            fn()
    times = tuple([] for _ in fns)
    for _ in range(runs):
        for fn, acc in zip(fns, times):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            acc.append(e0.elapsed_time(e1))
    return tuple(sorted(t)[len(t) // 2] for t in times)


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """The least ms the card could take: the larger of the operations over
    their peak rate and the bytes over the memory rate (H100 SXM data sheet,
    dense, at 700 W), and which of the two it is."""
    ops_ms, bytes_ms = flops / peak_flops * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def count_submits(extractor):
    """Wrap extractor.submit to count batches and the paths submitted."""
    seen = {"batches": 0, "paths": []}
    real = extractor.submit

    def submit(batch):
        seen["batches"] += 1
        seen["paths"].extend(batch.paths)
        return real(batch)

    extractor.submit = submit
    return seen


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from stutter_tpu_torch.ops.attn_probes import int8_attention_long, softmax_variant_attention
    from stutter_tpu_torch.ops.flash_mha import flash_mha, flash_mha_bias
    from stutter_tpu_torch.ops.logmel import whisper_log_mel
    from stutter_tpu_torch.ops.wavlm_attention import (
        gated_relpos_attention,
        gated_relpos_attention_backward,
    )
    from stutter_tpu_torch.ops.wavlm_stem import wavlm_fused_stem

    return {"gated_relpos_attention": gated_relpos_attention,
            "gated_relpos_attention_bwd": gated_relpos_attention_backward,
            "flash_mha": flash_mha, "whisper_log_mel": whisper_log_mel,
            "wavlm_fused_stem": wavlm_fused_stem, "flash_mha_bias": flash_mha_bias,
            "attn_int8": int8_attention_long, "attn_softmax_variants": softmax_variant_attention}


def zero_counts() -> None:
    """Every kernel's launch count, and the int8 GEMM count, to 0."""
    from stutter_tpu_torch.ops.quant import qdot

    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    qdot.calls = 0


def read_counts() -> dict:
    from stutter_tpu_torch.ops.quant import qdot

    counts = {name: wrapper.launches for name, wrapper in kernel_wrappers().items()}
    counts["int8_gemm"] = qdot.calls
    return counts


def check_resume(torch, pipe, extractor, meta, out: Path, results) -> None:
    """Rows in each split's latest checkpoint are not extracted again, and the
    resumed store's metadata is the first run's."""
    from stutter_tpu_torch.extract.checkpoint import find_latest_checkpoint, load_checkpoint

    first = {s: (out / s / "embedding_metadata.csv").read_bytes() for s in results}
    done = {}
    for split in results:
        n = find_latest_checkpoint(str(out), split)
        done[split] = {r["path"] for r in load_checkpoint(str(out), split, n)} if n else set()
    seen = count_submits(extractor)
    pipe.run(meta, str(out), resume=True)
    torch.cuda.synchronize()
    del extractor.submit
    skipped = sum(len(v) for v in done.values())
    check(skipped > 0, "no checkpointed rows to resume from")
    check(not set(seen["paths"]) & set().union(*done.values()),
          "resume re-extracted checkpointed rows")
    check(len(seen["paths"]) == len(meta) - skipped,
          f"resume extracted {len(seen['paths'])} rows, expected {len(meta) - skipped}")
    for split in results:
        check((out / split / "embedding_metadata.csv").read_bytes() == first[split],
              f"{split}: resumed metadata differs")
    say("resume", skipped_rows=skipped, extracted_rows=len(seen["paths"]))


def phase_slice(torch, extractor, work: Path, phase: str = "slice") -> dict:
    """The WavLM slice through ExtractionPipeline.run and a resumed run;
    returns the kernels' launch counts and the batches."""
    import numpy as np

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    cfg, layers, dim = extractor.cfg, extractor.layer_indices, extractor.embedding_dim
    corpus, out = work / "corpus", work / f"{phase}_store"
    audio_s = write_corpus(corpus, {"train": 12, "test": 6, "devel": 6}, (0.5, 4.0), seed=0)
    meta = create_metadata_from_files(str(corpus))
    pipe = ExtractionPipeline(extractor, batcher=BucketBatcher(frame_align=extractor.frame_align),
                              checkpoint_interval=5)
    seen = count_submits(extractor)
    zero_counts()
    t0 = time.perf_counter()
    results = pipe.run(meta, str(out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["gated_relpos_attention"]
    del extractor.submit
    check(counts["flash_mha"] == counts["whisper_log_mel"] == 0,
          f"the WavLM path launched a Whisper kernel: {counts}")
    check(counts["gated_relpos_attention_bwd"] == 0, "extraction launched the backward")
    check(counts["wavlm_fused_stem"] == 0, "the pipeline took the fused stem (off by default)")
    check(counts["flash_mha_bias"] == 0, "the pipeline took the long-bucket hatch (off by default)")
    int8 = 6 * cfg.num_hidden_layers * seen["batches"] if extractor.preset == "turbo" else 0
    check(counts["int8_gemm"] == int8,
          f"{counts['int8_gemm']} int8 GEMMs for {seen['batches']} batches, expected {int8}")
    for split, n in (("train", 12), ("test", 6), ("devel", 6)):
        d = out / split
        check((d / "embedding_metadata.csv").is_file(), f"{d}/embedding_metadata.csv missing")
        check(len(results[split]) == n, f"{split}: {len(results[split])} rows, expected {n}")
        for layer in layers:
            arr = np.load(d / f"layer_{layer}_embeddings.npy")
            check(arr.shape == (n, dim) and bool(np.isfinite(arr).all()),
                  f"{split} layer_{layer}: shape {arr.shape} or non-finite values")
    check((out / "checkpoints").is_dir() and any((out / "checkpoints").iterdir()),
          "no checkpoints written")
    expected = cfg.num_hidden_layers * seen["batches"]
    check(launches > 0 and launches == expected,
          f"attention kernel launched {launches} times for {seen['batches']} batches")
    say(phase, preset=extractor.preset, clips=len(meta), audio_s=f"{audio_s:.2f}",
        batches=seen["batches"], launches=launches,
        expected=f"{cfg.num_hidden_layers}x{seen['batches']}", int8_gemms=counts["int8_gemm"],
        wall_s=f"{wall:.2f}",
        store=f"3 splits x layers {','.join(map(str, layers))} x [n,{dim}]")

    check_resume(torch, pipe, extractor, meta, out, results)
    return dict(counts, batches=seen["batches"])


def wavlm_test_batch(torch, cfg):
    """One 16-clip batch of the 3 s bucket (L = 160 frames) on the card,
    ragged lengths from 0.5 s, prepared as the extractor prepares it."""
    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch

    g = torch.Generator(device="cuda").manual_seed(1)
    B, T = 16, 51_280
    lengths = torch.randint(8_000, T + 1, (B,), device="cuda", generator=g)
    lengths[0] = T
    wave = torch.randn(B, T, device="cuda", generator=g) * 0.1
    return wavlm_prepare_batch(wave, lengths, cfg.do_normalize), lengths


def phase_kernel_path_vs_plain(torch, attn, layers, fast_model, fid_model):
    """One 3 s bucket batch through encode with the kernel and the plain attention."""
    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
    from stutter_tpu_torch.ops.precision import no_tf32

    wave, lengths = wavlm_test_batch(torch, fast_model.cfg)
    B = wave.shape[0]
    dists = {}
    for name, model, bar in (("fast", fast_model, FAST_POOLED_COSINE),
                             ("fidelity", fid_model, FIDELITY_POOLED_COSINE)):
        with no_tf32() if name == "fidelity" else contextlib.nullcontext():
            k = model.encode(wave, layers, lengths)
            p = model.encode(wave, layers, lengths,
                             attention_fn=attn.gated_relpos_attention_reference)
        check(bool(torch.isfinite(k).all()), f"{name}: non-finite pooled embeddings")
        worst = max(cosine_distance(k[s, b], p[s, b])
                    for s in range(len(layers)) for b in range(B))
        dists[name] = worst
        check(worst <= bar, f"{name}: kernel path vs plain path cosine {worst:.3e} > {bar}")
    say("path", batch=f"{B}x3s", fast_cosine_dist=f"{dists['fast']:.3e}",
        fast_tol=FAST_POOLED_COSINE, fidelity_cosine_dist=f"{dists['fidelity']:.3e}",
        fidelity_tol=FIDELITY_POOLED_COSINE)


def phase_throughput(torch, extractor, work: Path, card: str) -> float:
    """The pipeline's audio-s/s in the extractor's preset over 10 full 3 s
    batches, and the device time of one batch's encode alone (input already
    on the card); returns the audio-s/s."""
    import numpy as np

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch

    corpus = work / "timing_corpus"
    audio_s = write_corpus(corpus, {"train": 1280}, (2.0, 3.0), seed=2)
    batcher = BucketBatcher(buckets_s=(3.0,), frame_align=extractor.frame_align)
    extractor.warmup(batcher)
    pipe = ExtractionPipeline(extractor, batcher=batcher, checkpoint_interval=10_000)
    meta = create_metadata_from_files(str(corpus))
    t0 = time.perf_counter()
    pipe.run(meta, str(work / f"timing_store_{extractor.preset}"), splits=("train",))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    batch = next(iter(batcher.batches([r["path"] for r in meta], prefetch=False)))
    lengths = torch.from_numpy(batch.lengths).cuda()
    wave = wavlm_prepare_batch(torch.from_numpy(batch.waves).cuda(), lengths,
                               extractor.cfg.do_normalize)
    times = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        extractor.model.encode(wave, extractor.layer_indices, lengths)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    encode_ms = float(np.median(times))
    say("throughput", preset=extractor.preset, clips=len(meta), audio_s=f"{audio_s:.1f}",
        wall_s=f"{wall:.3f}", audio_s_per_s=f"{audio_s / wall:.1f}",
        batch=f"{len(batch.lengths)}x3s", encode_device_ms=f"{encode_ms:.1f}",
        encode_audio_s_per_s=f"{batch.audio_seconds / (encode_ms / 1e3):.1f}",
        card=f'"{card}"')
    return audio_s / wall


def whisper_test_clips(torch, B: int, seed: int):
    """[B, 480000] f32 on the card: noise and tone, with a silent clip, a
    quiet clip (peak 1e-3) and a clip of 2 s of audio followed by zeros."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = 480_000
    t = torch.arange(T, device="cuda") / 16000.0
    f0 = torch.rand(B, 1, device="cuda", generator=g) * 500 + 100
    wave = 0.1 * torch.randn(B, T, device="cuda", generator=g) + 0.2 * torch.sin(
        2 * torch.pi * f0 * t[None])
    wave[0] = 0.0
    wave[1] *= 1e-3 / wave[1].abs().max()
    wave[2, 32_000:] = 0.0
    return wave


def logmel_work(wave, out, n_mels: int) -> tuple[float, float, float]:
    """The least work of the log-mel, as f32 operations outside the tensor
    cores, per frame: the window (400), a 400-point real FFT (2.5 N log2 N),
    the power of 201 bins (3 each), the mel bank's nonzero taps (2 each; each
    bin lies in at most two triangles), the log and the floor-affine (4 per
    mel); the bytes of the wave read once and the features written once.
    Also the operations of the kernel's design, the dense 400 x 402 DFT and
    201 x n_mels mel products."""
    import math

    from stutter_tpu_torch.ops.logmel import WHISPER_N_FFT, WHISPER_SR, _whisper_mel_matrix

    n = WHISPER_N_FFT
    taps = int((_whisper_mel_matrix(n, n_mels, WHISPER_SR) != 0).sum())
    frames = wave.shape[0] * out.shape[-1]
    per_frame = n + 2.5 * n * math.log2(n) + 3 * (n // 2 + 1) + 2 * taps + 4 * n_mels
    dense = 2 * (n * 2 * (n // 2 + 1) + (n // 2 + 1) * n_mels)
    nbytes = wave.numel() * wave.element_size() + out.numel() * out.element_size() + 4 * taps
    return frames * per_frame, nbytes, frames * dense


def phase_logmel(torch, logmel):
    """Log-mel kernel against its plain version at the path's 16 x 30 s;
    returns (worst max-abs error, the numbers at 80 mels)."""
    worst, headline = 0.0, None
    for n_mels in (80, 128):
        wave = whisper_test_clips(torch, 16, seed=n_mels)
        out = logmel.whisper_log_mel(wave, n_mels)
        ref = logmel.log_mel_spectrogram_reference(wave, n_mels)
        torch.cuda.synchronize()
        check(out.shape == ref.shape == (16, n_mels, 3000) and out.dtype == torch.float32,
              f"log-mel kernel output {out.dtype} {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "log-mel kernel output has non-finite values")
        max_abs = float((out - ref).abs().max())
        silent_ok = bool((out[0] == out[0, 0, 0]).all())  # one constant image
        ms, plain_ms = time_turns(torch, lambda: logmel.whisper_log_mel(wave, n_mels),
                                 lambda: logmel.log_mel_spectrogram_reference(wave, n_mels))
        flops, nbytes, dense_flops = logmel_work(wave, out, n_mels)
        numbers = timing(ms, plain_ms, *bound(flops, nbytes, F32_FLOPS))
        # the kernel's own design (the dense windowed DFT as a product) for comparison
        dense_ms, _ = bound(dense_flops, nbytes, F32_FLOPS)
        say("logmel", shape="16x480000", n_mels=n_mels, max_abs_err=f"{max_abs:.3e}",
            max_abs_tol=LOGMEL_MAX_ABS, silent_clip_exact=silent_ok, **shown(numbers),
            bound_dense_dft_ms=f"{dense_ms:.4f}")
        check(max_abs <= LOGMEL_MAX_ABS and silent_ok,
              f"log-mel kernel disagrees with its plain version at {n_mels} mels")
        worst = max(worst, max_abs)
        headline = headline or numbers
    return worst, headline


def phase_mha(torch, mha):
    """Flash-attention kernel against its plain version, and the time of
    ``scaled_dot_product_attention`` on the same inputs; returns (worst
    max-abs error, the numbers at the bf16 encoder shape)."""
    import torch.nn.functional as F

    cases = [  # (B, H, L, dtype, kv_valid): [B, L, H, d] views, as the encoder passes them
        (16, 20, 1500, torch.bfloat16, None),   # Whisper-large encoder, fast preset
        (16, 20, 1500, torch.float32, None),    # fidelity preset
        (3, 20, 1500, torch.bfloat16, (1500, 700, 0)),
        (3, 20, 1500, torch.float32, (1500, 700, 0)),
        (5, 20, 37, torch.bfloat16, None),      # ragged L, one partial tile
        (5, 20, 37, torch.float32, None),
    ]
    g = torch.Generator(device="cuda").manual_seed(0)
    worst, headline = 0.0, None
    for B, H, L, dtype, kv in cases:
        q, k, v = ((torch.randn(B, L, H, 64, device="cuda", generator=g) * 0.5)
                   .to(dtype).transpose(1, 2) for _ in range(3))
        kv_valid = None if kv is None else torch.tensor(kv, dtype=torch.int32, device="cuda")
        out = mha.flash_mha(q, k, v, kv_valid)
        ref = mha.flash_mha_reference(q, k, v, kv_valid)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == dtype and out.stride() == q.stride(),
              f"flash_mha output {out.dtype} {tuple(out.shape)} {out.stride()}")
        check(bool(torch.isfinite(out).all()), "flash_mha output has non-finite values")
        max_abs = float((out.float() - ref.float()).abs().max())
        cos = cosine_distance(out.float(), ref.float())
        tol_abs, tol_cos = ((BF16_MAX_ABS, BF16_COSINE) if dtype == torch.bfloat16
                            else (F32_MAX_ABS, F32_COSINE))
        # the library's one call for the same function: scaled_dot_product_attention
        # with q's scale 1 (q comes pre-scaled) and the additive key-padding mask
        # (-1e9 past each clip's keys; every key valid where kv_valid is None)
        valid = kv_valid if kv_valid is not None else torch.full(
            (B,), L, dtype=torch.int32, device="cuda")
        key_mask = torch.where(torch.arange(L, device="cuda")[None, :] < valid[:, None],
                               0.0, -1e9).to(dtype)[:, None, None, :]
        ms, plain_ms, library_ms = time_turns(
            torch, lambda: mha.flash_mha(q, k, v, kv_valid),
            lambda: mha.flash_mha_reference(q, k, v, kv_valid),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask, scale=1.0))
        n = B * H * L * 64  # q k^T and p v; q, k, v and out once each
        numbers = timing(ms, plain_ms, *bound(4 * n * L, 4 * n * q.element_size(),
                                              peak_flops(torch, dtype)), library_ms)
        say("mha", shape=f"{B}x{H}x{L}x64", dtype=str(dtype).split(".")[-1],
            kv_valid=",".join(map(str, kv)) if kv else "all", max_abs_err=f"{max_abs:.3e}",
            max_abs_tol=tol_abs, cosine_dist=f"{cos:.3e}", cosine_tol=tol_cos,
            **shown(numbers))
        check(max_abs <= tol_abs and cos <= tol_cos,
              f"flash_mha disagrees with its plain version at {B}x{H}x{L} {dtype} kv={kv}")
        worst = max(worst, max_abs)
        headline = headline or numbers
    return worst, headline


def phase_mha_bias(torch, mha):
    """The materialised-bias flash kernel against its plain version at the
    hatch's 30 s and 20 s buckets (bf16, keys masked for short clips) and
    at a ragged f32 length, with ``scaled_dot_product_attention`` given the
    same ab as its mask (cast to q's dtype, as the call requires); returns
    (worst max-abs error, the numbers at the 30 s bucket)."""
    import torch.nn.functional as F

    cases = [(12, 16, 1504, torch.bfloat16), (19, 16, 1008, torch.bfloat16),
             (3, 16, 37, torch.float32)]
    g = torch.Generator(device="cuda").manual_seed(9)
    worst, headline = 0.0, None
    for B, H, L, dtype in cases:
        lengths = torch.randint(L // 4, L + 1, (B,), device="cuda", generator=g)
        lengths[0] = L
        q, k, v, bias, gate, mask = attention_inputs(torch, g, B, H, L, dtype, lengths)
        ab = (gate[..., None] * bias[None]).add_(mask[:, None, None, :])
        out = mha.flash_mha_bias(q, k, v, ab)
        ref = mha.flash_mha_bias_reference(q, k, v, ab)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == dtype and out.stride() == q.stride(),
              f"flash_mha_bias output {out.dtype} {tuple(out.shape)} {out.stride()}")
        check(bool(torch.isfinite(out).all()), "flash_mha_bias output has non-finite values")
        max_abs = float((out.float() - ref.float()).abs().max())
        cos = cosine_distance(out.float(), ref.float())
        tol_abs, tol_cos = ((BF16_MAX_ABS, BF16_COSINE) if dtype == torch.bfloat16
                            else (F32_MAX_ABS, F32_COSINE))
        ab_q = ab.to(dtype)
        ms, plain_ms, library_ms = time_turns(
            torch, lambda: mha.flash_mha_bias(q, k, v, ab),
            lambda: mha.flash_mha_bias_reference(q, k, v, ab),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=ab_q, scale=1.0))
        n = B * H * L * 64  # q k^T and p v; q, k, v, out and ab once each
        numbers = timing(ms, plain_ms, *bound(4 * n * L, 4 * n * q.element_size() + 4 * ab.numel(),
                                              peak_flops(torch, dtype)), library_ms)
        say("mha_bias", shape=f"{B}x{H}x{L}x64", dtype=str(dtype).split(".")[-1],
            max_abs_err=f"{max_abs:.3e}", max_abs_tol=tol_abs, cosine_dist=f"{cos:.3e}",
            cosine_tol=tol_cos, ab_gb=f"{4 * ab.numel() / 1e9:.3f}", **shown(numbers))
        check(max_abs <= tol_abs and cos <= tol_cos,
              f"flash_mha_bias disagrees with its plain version at {B}x{H}x{L} {dtype}")
        worst = max(worst, max_abs)
        headline = headline or numbers
        del q, k, v, bias, gate, mask, ab, ab_q, out, ref
        torch.cuda.empty_cache()
    return worst, headline


def probe_case(torch, g, B, L):
    """The probes' operands on the card: contiguous bf16 q, k, v (randn *
    0.3), bias, gate and a key mask that cuts the last clip short."""
    H = 16
    q, k, v = ((torch.randn(B, H, L, 64, device="cuda", generator=g) * 0.3).to(torch.bfloat16)
               for _ in range(3))
    bias = torch.randn(H, L, L, device="cuda", generator=g)
    gate = torch.rand(B, H, L, device="cuda", generator=g)
    mask = torch.zeros(B, L, device="cuda")
    mask[-1, L // 2:] = -1e9
    return q, k, v, bias, gate, mask


def check_int8_operands(torch, probes, k, v) -> None:
    """The prologue's int8 k and v and their scales equal the plain
    version's bit for bit; vq's padding past L is 0."""
    kq, sk, vqt, sv = probes.quantize_kv(k, v)
    rkq, rsk, rvq, rsv = probes.quantize_kv_reference(k, v)
    L = k.shape[2]
    torch.cuda.synchronize()
    check(torch.equal(kq, rkq) and torch.equal(sk, rsk), "int8 k or its scales differ")
    check(torch.equal(vqt[..., :L].transpose(-1, -2), rvq) and torch.equal(sv, rsv)
          and not bool(vqt[..., L:].any()), "int8 v or its scales differ")


def phase_probe_kernels(torch, probes, card: str):
    """The int8 probe's kernels and the four softmax variants against their
    plain versions at the probes' 30 s case (25 x 16 x 1504 x 64) and a
    ragged length, the int8 operands bit-equal; returns {kernel: (worst
    max-abs error, the numbers at the 30 s case)}."""
    g = torch.Generator(device="cuda").manual_seed(12)
    result = {"attn_int8": (0.0, None), "attn_softmax_variants": (0.0, None)}
    for B, L in ((25, 1504), (3, 37)):
        q, k, v, bias, gate, mask = args = probe_case(torch, g, B, L)
        check_int8_operands(torch, probes, k, v)
        n = B * 16 * L * 64  # q k^T and a v; q, k, v, out once, bias, gate, mask
        nbytes = 4 * n * 2 + 4 * (16 * L * L + B * 16 * L + B * L)
        runs = [("attn_int8", "int8", lambda: probes.int8_attention_long(*args),
                 lambda: probes.int8_attention_long_reference(*args), INT8_OPS,
                 INT8_MAX_ABS, INT8_COSINE)]
        for name, (postnorm, chain) in probes.VARIANTS.items():
            runs.append(("attn_softmax_variants", name,
                         lambda pn=postnorm, c=chain: probes.softmax_variant_attention(*args, pn, c),
                         lambda pn=postnorm, c=chain: probes.softmax_variant_attention_reference(
                             *args, pn, c), BF16_FLOPS, VARIANT_MAX_ABS, VARIANT_COSINE[name]))
        for kernel, name, fn, plain, peak, tol_abs, tol_cos in runs:
            out, ref = fn(), plain()
            torch.cuda.synchronize()
            check(out.shape == ref.shape and out.dtype == torch.bfloat16,
                  f"{name} output {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"{name} output has non-finite values")
            max_abs = float((out.float() - ref.float()).abs().max())
            cos = cosine_distance(out.float(), ref.float())
            del out, ref
            ms, plain_ms = time_turns(torch, fn, plain, runs=10)
            numbers = timing(ms, plain_ms, *bound(4 * n * L, nbytes, peak))
            say("probe_kernel", kernel=name, shape=f"{B}x16x{L}x64",
                max_abs_err=f"{max_abs:.3e}", max_abs_tol=tol_abs, cosine_dist=f"{cos:.3e}",
                cosine_tol=tol_cos, **shown(numbers), card=f'"{card}"')
            check(max_abs <= tol_abs and cos <= tol_cos,
                  f"{name} disagrees with its plain version at {B}x16x{L}")
            worst, headline = result[kernel]
            result[kernel] = (max(worst, max_abs), headline or numbers)
            torch.cuda.empty_cache()
        del q, k, v, bias, gate, mask, args, runs
    return result


def phase_long_slice(torch, extractor, work: Path) -> dict:
    """WavLM-Large fast through ExtractionPipeline.run on clips of the 3 s,
    20 s and 30 s buckets (one split each, so one batch each), once with
    long_attention="gated" and once with "materialized_bias" (the JAX
    package's escape hatch from L = 1008 up): the launch counts, the store,
    and the pooled cosine distance between the two runs. Returns the hatch
    run's launch counts."""
    import numpy as np

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, WavLMExtractor
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    corpus = work / "long_corpus"
    sizes = {"train": 6, "test": 3, "devel": 3}  # 3 s, 20 s and 30 s buckets
    audio_s = write_corpus(corpus, sizes, {"train": (2.5, 2.95), "test": (15.5, 19.5),
                                           "devel": (25.0, 29.5)}, seed=8)
    meta = create_metadata_from_files(str(corpus))
    n_layers, layers = extractor.cfg.num_hidden_layers, extractor.layer_indices
    runs = {}
    for mode in ("gated", "materialized_bias"):
        ex = WavLMExtractor(extractor.model, "cuda", preset="fast", long_attention=mode)
        pipe = ExtractionPipeline(ex, batcher=BucketBatcher(frame_align=ex.frame_align),
                                  checkpoint_interval=10_000)
        lengths = []
        real = ex.submit
        ex.submit = lambda batch: lengths.append(
            int(ex.frame_count(batch.waves.shape[1]))) or real(batch)
        zero_counts()
        t0 = time.perf_counter()
        results = pipe.run(meta, str(work / f"long_store_{mode}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        long_batches = sum(L >= 1008 for L in lengths)
        hatch = n_layers * long_batches if mode == "materialized_bias" else 0
        check(sorted(lengths) == [160, 1008, 1504], f"{mode}: batches of L = {lengths}")
        check(counts["flash_mha_bias"] == hatch
              and counts["gated_relpos_attention"] == n_layers * len(lengths) - hatch,
              f"{mode}: launches {counts}, expected flash_mha_bias {hatch} and "
              f"gated_relpos_attention {n_layers * len(lengths) - hatch}")
        for split, n in sizes.items():
            check(len(results[split]) == n, f"{mode} {split}: {len(results[split])} rows")
            for layer in layers:
                arr = np.load(work / f"long_store_{mode}" / split / f"layer_{layer}_embeddings.npy")
                check(arr.shape == (n, extractor.embedding_dim) and bool(np.isfinite(arr).all()),
                      f"{mode} {split} layer_{layer}: shape {arr.shape} or non-finite values")
        runs[mode] = (results, counts)
        say("long_slice", long_attention=mode, clips=len(meta), audio_s=f"{audio_s:.2f}",
            frames=",".join(map(str, lengths)), flash_mha_bias=counts["flash_mha_bias"],
            gated_relpos_attention=counts["gated_relpos_attention"],
            expected=f"{hatch},{n_layers * len(lengths) - hatch}", wall_s=f"{wall:.2f}")
    worst = max(cosine_distance(torch.from_numpy(a[f"layer_{layer}"]),
                                torch.from_numpy(b[f"layer_{layer}"]))
                for split in sizes
                for a, b in zip(runs["gated"][0][split], runs["materialized_bias"][0][split])
                for layer in layers)
    say("long_slice", hatch_vs_gated_pooled_cosine_dist=f"{worst:.3e}", tol=FAST_POOLED_COSINE)
    check(worst <= FAST_POOLED_COSINE,
          f"the hatch's pooled embeddings are {worst:.3e} from the gated path's")
    return runs["materialized_bias"][1]


def phase_probes(torch, card: str) -> dict:
    """Both probe CLIs in-process at their defaults: their JSON, their
    fidelity against f32 and their launches. Returns the launch counts."""
    import io

    from stutter_tpu_torch.cli import _attn_probe, attn_int8_probe, attn_softmax_variants_probe
    from stutter_tpu_torch.ops.attn_probes import VARIANTS

    args = _attn_probe.parse_args("", [])
    n_cases = len(_attn_probe.cases(args.cases))
    calls = 2 + args.iters * args.loops  # fidelity, warm-up, timing rounds
    zero_counts()
    for cli, kernel, expected, names in (
            (attn_int8_probe, "attn_int8", n_cases * calls, ["int8", "bf16"]),
            (attn_softmax_variants_probe, "attn_softmax_variants",
             n_cases * len(VARIANTS) * calls, list(VARIANTS) + ["src_incumbent"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([])
        check(rc == 0, f"{cli.__name__} returned {rc}")
        r = json.loads(buf.getvalue().strip().splitlines()[-1])
        launches = read_counts()[kernel]
        for name, case in r["cases"].items():
            cosines = {k: v for k, v in case.items() if k.endswith("cosine")}
            check(all(v == v and 0 <= v < 1 for v in cosines.values()),
                  f"{kernel} {name}: cosines {cosines}")
            check(all(v <= PROBE_F32_COSINE for k, v in cosines.items() if "int8" not in k),
                  f"{kernel} {name}: {cosines} from f32, bar {PROBE_F32_COSINE}")
            say("probes", cli=cli.__name__.rsplit(".", 1)[-1], case=name, B=case["B"],
                block_q=case["block_q"], **{k: f"{v:.3e}" for k, v in cosines.items()},
                **{f"{n}_ms": ",".join(f"{t:.4f}" for t in case[f"{n}_ms"]) for n in names},
                card=f'"{card}"')
        check(launches == expected, f"{kernel}: {launches} launches, expected {expected}")
        say("probes", kernel=kernel, launches=launches, expected=expected)
        torch.cuda.empty_cache()
    return read_counts()


def phase_whisper_slice(torch, extractor, work: Path, phase: str = "whisper_slice") -> dict:
    """The Whisper slice through a default-constructed pipeline; returns the
    kernels' launch counts."""
    import numpy as np

    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    cfg, dim = extractor.cfg, extractor.embedding_dim
    corpus, out = work / "whisper_corpus", work / f"{phase}_store"
    sizes = {"train": 30, "test": 6, "devel": 6}
    audio_s = write_corpus(corpus, sizes, (0.5, 4.0), seed=3)
    meta = create_metadata_from_files(str(corpus))
    pipe = ExtractionPipeline(extractor, checkpoint_interval=13)
    check(pipe.batcher.buckets_s == (30.0,), f"whisper batched in {pipe.batcher.buckets_s}")
    seen = count_submits(extractor)
    zero_counts()
    t0 = time.perf_counter()
    results = pipe.run(meta, str(out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del extractor.submit
    batches = seen["batches"]
    for split, n in sizes.items():
        d = out / split
        check((d / "embedding_metadata.csv").is_file(), f"{d}/embedding_metadata.csv missing")
        check(len(results[split]) == n, f"{split}: {len(results[split])} rows, expected {n}")
        check(len(extractor.column_names) == 6, f"columns {extractor.column_names}")
        for col in extractor.column_names:
            arr = np.load(d / f"{col}_embeddings.npy")
            check(arr.shape == (n, dim) and bool(np.isfinite(arr).all()),
                  f"{split} {col}: shape {arr.shape} or non-finite values")
    check((out / "checkpoints").is_dir() and any((out / "checkpoints").iterdir()),
          "no checkpoints written")
    check(counts["whisper_log_mel"] == batches > 0,
          f"log-mel kernel launched {counts['whisper_log_mel']} times for {batches} batches")
    check(counts["flash_mha"] == cfg.encoder_layers * batches,
          f"flash_mha launched {counts['flash_mha']} times for {batches} batches")
    check(counts["gated_relpos_attention"] == counts["gated_relpos_attention_bwd"]
          == counts["wavlm_fused_stem"] == 0, "the Whisper path launched WavLM's kernels")
    # turbo: q, k, v, fc1, fc2 of each encoder layer; attn_o and the decoder stay bf16
    int8 = 5 * cfg.encoder_layers * batches if extractor.preset == "turbo" else 0
    check(counts["int8_gemm"] == int8,
          f"{counts['int8_gemm']} int8 GEMMs for {batches} batches, expected {int8}")
    say(phase, preset=extractor.preset, clips=len(meta), audio_s=f"{audio_s:.2f}",
        batches=batches, batch=pipe.batcher.batch_size_for(30.0),
        log_mel_launches=counts["whisper_log_mel"], flash_mha_launches=counts["flash_mha"],
        int8_gemms=counts["int8_gemm"], expected=f"{batches},{cfg.encoder_layers}x{batches}",
        wall_s=f"{wall:.2f}", store=f"3 splits x {','.join(extractor.column_names)} x [n,{dim}]")
    check_resume(torch, pipe, extractor, meta, out, results)
    return dict(counts, batches=batches)


def phase_whisper_path(torch, fast_model, fid_model):
    """One 16 x 30 s batch through the kernel path and the plain path (plain
    log-mel, plain attention), in both presets; the encoder and the decoder
    columns are held to their own bars in fast (see
    WHISPER_FAST_DECODER_COSINE), and the plain fast path's distance from
    the plain fidelity path is printed as the bf16 floor."""
    from stutter_tpu_torch.frontend.whisper_frontend import whisper_features
    from stutter_tpu_torch.ops.flash_mha import flash_mha_reference
    from stutter_tpu_torch.ops.logmel import log_mel_spectrogram_reference
    from stutter_tpu_torch.ops.precision import no_tf32

    wave = whisper_test_clips(torch, 16, seed=5)
    n = fast_model.cfg.encoder_layers
    idx = (n, n - 1, n - 2)
    runs = {}
    for name, model in (("fast", fast_model), ("fidelity", fid_model)):
        with no_tf32() if name == "fidelity" else contextlib.nullcontext():
            runs[name, "kernel"] = model.embed(whisper_features(wave), idx, idx)
            runs[name, "plain"] = model.embed(log_mel_spectrogram_reference(wave), idx, idx,
                                              attention_fn=flash_mha_reference)
        check(runs[name, "kernel"].shape == (6, 16, model.cfg.d_model)
              and bool(torch.isfinite(runs[name, "kernel"]).all()),
              f"{name}: pooled embeddings non-finite or of the wrong shape")

    def worst(a, b, cols):
        return max(cosine_distance(runs[a][s, i], runs[b][s, i]) for s in cols for i in range(16))

    enc, dec = range(3), range(3, 6)
    d = {"fast_enc": worst(("fast", "kernel"), ("fast", "plain"), enc),
         "fast_dec": worst(("fast", "kernel"), ("fast", "plain"), dec),
         "fid": worst(("fidelity", "kernel"), ("fidelity", "plain"), range(6)),
         "floor_enc": worst(("fast", "plain"), ("fidelity", "plain"), enc),
         "floor_dec": worst(("fast", "plain"), ("fidelity", "plain"), dec)}
    say("whisper_path", batch="16x30s", fast_encoder_cosine_dist=f"{d['fast_enc']:.3e}",
        fast_encoder_tol=FAST_POOLED_COSINE, fast_decoder_cosine_dist=f"{d['fast_dec']:.3e}",
        fast_decoder_tol=WHISPER_FAST_DECODER_COSINE,
        fidelity_cosine_dist=f"{d['fid']:.3e}", fidelity_tol=FIDELITY_POOLED_COSINE,
        plain_fast_vs_fidelity_encoder=f"{d['floor_enc']:.3e}",
        plain_fast_vs_fidelity_decoder=f"{d['floor_dec']:.3e}")
    check(d["fast_enc"] <= FAST_POOLED_COSINE,
          f"fast encoder columns: kernel vs plain path cosine {d['fast_enc']:.3e}")
    check(d["fast_dec"] <= WHISPER_FAST_DECODER_COSINE,
          f"fast decoder columns: kernel vs plain path cosine {d['fast_dec']:.3e}")
    check(d["fid"] <= FIDELITY_POOLED_COSINE,
          f"fidelity: kernel vs plain path cosine {d['fid']:.3e}")


def phase_whisper_throughput(torch, extractor, work: Path, card: str) -> float:
    """The Whisper pipeline in the extractor's preset over 64 clips of 2-3 s
    in batches of 16 (the CLI's batch), after a warm batch, and one batch's
    device time; returns the clips/s."""
    import numpy as np

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.frontend.whisper_frontend import whisper_features

    corpus = work / "whisper_timing_corpus"
    audio_s = write_corpus(corpus, {"train": 64}, (2.0, 3.0), seed=4)
    batcher = BucketBatcher(buckets_s=(30.0,), audio_budget_s=30.0 * 16, max_batch=16)
    extractor.warmup(batcher)
    pipe = ExtractionPipeline(extractor, batcher=batcher, checkpoint_interval=10_000)
    meta = create_metadata_from_files(str(corpus))
    t0 = time.perf_counter()
    pipe.run(meta, str(work / f"whisper_timing_store_{extractor.preset}"), splits=("train",))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    batch = next(iter(batcher.batches([r["path"] for r in meta], prefetch=False)))
    wave = torch.from_numpy(batch.waves).cuda()
    model, cfg = extractor.model, extractor.cfg
    times = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        model.embed(whisper_features(wave, cfg.num_mel_bins), extractor.encoder_indices,
                    extractor.decoder_indices)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    encode_ms = float(np.median(times))
    say("whisper_throughput", preset=extractor.preset, clips=len(meta),
        audio_s=f"{audio_s:.1f}",
        wall_s=f"{wall:.3f}", clips_per_s=f"{len(meta) / wall:.2f}",
        audio_s_per_s=f"{audio_s / wall:.1f}", batch=f"{len(batch.lengths)}x30s",
        encode_device_ms=f"{encode_ms:.1f}",
        encode_clips_per_s=f"{len(batch.lengths) / (encode_ms / 1e3):.2f}",
        card=f'"{card}"')
    return len(meta) / wall


def group_cosines(grads_a: dict, grads_b: dict) -> dict:
    """Gradient cosine distance per group: encoder (the backbone above the
    frozen stem), layer weights, head."""
    import torch

    groups = {"encoder": lambda n: n.startswith("backbone."),
              "layer_weights": lambda n: n == "layer_weights",
              "head": lambda n: n.startswith("head.")}
    out = {}
    for group, member in groups.items():
        names = sorted(n for n in grads_b if member(n) and grads_b[n] is not None)
        check(bool(names) and all(grads_a.get(n) is not None for n in names),
              f"no or missing {group} gradients")
        a = torch.cat([grads_a[n].float().flatten() for n in names])
        b = torch.cat([grads_b[n].float().flatten() for n in names])
        check(bool(torch.isfinite(a).all()), f"{group} gradients have non-finite values")
        out[group] = cosine_distance(a, b)
    return out


def phase_finetune_path(torch, attn, cfg_model, device: str = "cuda", T: int = 51_280):
    """One fixed training step at 8 x 3 s (no SpecAugment, no dropout,
    per-layer remat) through the kernel Function and through the plain
    attention, in bf16 and f32: the loss and the gradient cosine distance
    per group, and the kernel run's launches (2 forwards, 1 backward a layer)."""
    import dataclasses

    import numpy as np

    from stutter_tpu_torch.train.finetune import (
        FinetuneConfig,
        FinetuneTrainer,
        init_finetune_model,
    )

    mcfg = dataclasses.replace(cfg_model, apply_spec_augment=False)
    rng = np.random.RandomState(11)
    B = 8  # T = 51 280 samples: the CLI's 3 s bucket, L = 160 frames
    lengths = rng.randint(T * 5 // 8, T + 1, size=B)
    lengths[0] = T
    waves = (rng.randn(B, T) * 0.1 * (np.arange(T)[None] < lengths[:, None])).astype(np.float32)
    labels, cw = rng.randint(0, 4, size=B), np.array([1.0, 2.0, 0.5, 1.5], np.float32)
    batch = [torch.from_numpy(waves).to(device), torch.from_numpy(lengths).long().to(device),
             torch.from_numpy(labels).long().to(device), torch.ones(B, device=device)]
    state = init_finetune_model(FinetuneConfig(model=mcfg, n_classes=4)).state_dict()
    n_layers = mcfg.num_hidden_layers
    for name, dtype, loss_bar, cos_bar in (
            ("bf16", torch.bfloat16, FT_BF16_LOSS_REL, FT_BF16_GRAD_COSINE),
            ("f32", torch.float32, FT_F32_LOSS_REL, FT_F32_GRAD_COSINE)):
        cfg = FinetuneConfig(model=mcfg, n_classes=4, head_dropout=0.0, activation_dtype=dtype)
        trainer = FinetuneTrainer(cfg, device=device, params=state)
        runs = {}
        for path, fn in (("kernel", None), ("plain", attn.gated_relpos_attention_reference)):
            trainer.attention_fn = fn
            zero_counts()
            grads, loss, _ = trainer.gradients([batch], cw, normalize_in_graph=True)
            runs[path] = (grads, float(loss), read_counts())
        (g_k, loss_k, counts), (g_p, loss_p, plain_counts) = runs["kernel"], runs["plain"]
        on_card = device == "cuda"
        check(counts["gated_relpos_attention"] == 2 * n_layers * on_card
              and counts["gated_relpos_attention_bwd"] == n_layers * on_card,
              f"{name} kernel step launched {counts}, expected {2 * n_layers} forwards "
              f"and {n_layers} backwards")
        check(not any(plain_counts.values()), f"the plain step launched {plain_counts}")
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        cos = group_cosines(g_k, g_p)
        say("finetune_path", batch=f"{B}x3s", dtype=name, layers=n_layers, loss=f"{loss_k:.6f}",
            plain_loss=f"{loss_p:.6f}", loss_rel=f"{loss_rel:.2e}", loss_rel_tol=loss_bar,
            **{f"{k}_grad_cosine_dist": f"{v:.3e}" for k, v in cos.items()},
            grad_cosine_tol=cos_bar, fwd_launches=counts["gated_relpos_attention"],
            bwd_launches=counts["gated_relpos_attention_bwd"])
        check(np.isfinite(loss_k) and loss_rel <= loss_bar,
              f"{name}: kernel step loss {loss_k} vs plain {loss_p}")
        for group, d in cos.items():
            check(d <= cos_bar, f"{name}: {group} gradient cosine {d:.3e} > {cos_bar}")
        del trainer, runs, g_k, g_p


class TrainerSpy:
    """Watches ``FinetuneTrainer`` while the CLI runs: the trainers built,
    the microbatches and shape of each gradient pass, the eval batches, each
    update's span on the device timeline, aux, audio seconds and host
    enqueue ms, and
    the watched parameters as they were before the first update."""

    def __init__(self, torch, watch):
        self.torch, self.watch = torch, watch
        self.trainers, self.passes, self.updates = [], [], []
        self.eval_batches, self.before = 0, None

    def mark(self):
        """A point on the device timeline (the host clock without a card)."""
        torch = self.torch
        if not torch.cuda.is_available():
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    @staticmethod
    def ms(start, end) -> float:
        if isinstance(start, float):
            return (end - start) * 1e3
        end.synchronize()
        return start.elapsed_time(end)

    @contextlib.contextmanager
    def attached(self):
        import numpy as np

        from stutter_tpu_torch.train.finetune import FinetuneTrainer

        names = ("__init__", "gradients", "predict", "step", "step_accum")
        real = {n: getattr(FinetuneTrainer, n) for n in names}
        spy = self

        def __init__(trainer, *args, **kw):
            real["__init__"](trainer, *args, **kw)
            spy.trainers.append(trainer)

        def gradients(trainer, microbatches, *args, **kw):
            if spy.before is None:
                spy.before = {n: trainer.params[n].detach().clone() for n in spy.watch}
            spy.passes.append((len(microbatches), {tuple(mb[0].shape) for mb in microbatches}))
            return real["gradients"](trainer, microbatches, *args, **kw)

        def predict(trainer, *args, **kw):
            spy.eval_batches += 1
            return real["predict"](trainer, *args, **kw)

        def timed_update(name, audio_of):
            def update(trainer, *args, **kw):
                start, host0 = spy.mark(), time.perf_counter()
                aux = real[name](trainer, *args, **kw)
                host_ms = (time.perf_counter() - host0) * 1e3
                spy.updates.append((start, spy.mark(), aux, audio_of(*args), host_ms))
                return aux
            return update

        def clip_seconds(lengths):
            return float(np.sum(lengths)) / 16000.0

        patched = {
            "__init__": __init__, "gradients": gradients, "predict": predict,
            "step": timed_update("step", lambda w, lengths, *_: clip_seconds(lengths)),
            "step_accum": timed_update("step_accum", lambda mbs, *_: sum(
                clip_seconds(mb[1]) for mb in mbs))}
        for n, fn in patched.items():
            setattr(FinetuneTrainer, n, fn)
        try:
            yield self
        finally:
            for n, fn in real.items():
                setattr(FinetuneTrainer, n, fn)


def phase_finetune(torch, work: Path, card: str, device: str = "cuda", batch_size: int = 32,
                   clips=(128, 6, 12), durations=((2.0, 3.0), (8.2, 9.8)),
                   max_length: float = 10.0) -> dict:
    """The fine-tune CLI end to end at WavLM-Large (random weights, seed 0)
    on a synthetic labeled corpus of ``clips`` = (short train clips, long
    train clips, clips per eval split): 2 epochs with a checkpoint after
    each, a --resume run for a third, and a --grad_accum 2 run. Checks the
    losses, that the backbone moved and the frozen stem did not, the launch
    counts, the resume, the outputs; prints ms per update, training
    audio-s/s and peak memory. Returns the first run's launch counts."""
    import math

    import numpy as np

    from stutter_tpu_torch.cli import finetune as cli
    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.models.wavlm import WavLMConfig
    from stutter_tpu_torch.train.checkpointing import latest_step

    on_card = device == "cuda"
    n_layers = WavLMConfig.large().num_hidden_layers
    n_short, n_long, n_eval = clips
    corpus = work / "ft_corpus"
    write_corpus(corpus, {"train": n_short, "test": n_eval, "devel": n_eval}, durations[0],
                 seed=6, long_per_split={"train": n_long, "test": 1}, long_range=durations[1])
    # the CLI's batch plan, for the expected number of updates
    batcher = BucketBatcher(audio_budget_s=batch_size * 3.0, max_batch=batch_size,
                            max_length_s=max_length)
    train = [r["path"] for r in create_metadata_from_files(str(corpus), split="all")
             if r["split"] == "train"]
    per_bucket = [math.ceil(len(idxs) / batcher.batch_size_for(b))
                  for b, idxs in batcher.assign_buckets(train).items()]
    n_batches = sum(per_bucket)
    ckpt, results, results_accum = work / "ft_ckpt", work / "ft_results", work / "ft_accum"
    common = ["--data_dir", str(corpus), "--random_init", "--batch_size", str(batch_size),
              "--max_length", str(max_length), "--device", device]
    watch = ("backbone.feature_encoder.layers.0.weight", "backbone.layers.0.attention.q_w",
             f"backbone.layers.{n_layers - 1}.feed_forward.w2", "head.layers.0.w")

    def run(what, args, epochs, updates, microbatches):
        spy = TrainerSpy(torch, watch)
        zero_counts()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with spy.attached():
            t0 = time.perf_counter()
            rc = cli.main(common + args)
            wall = time.perf_counter() - t0
        counts = read_counts()
        check(rc == 0, f"finetune {what}: the CLI returned {rc}")
        losses = [float(aux["loss"]) for _, _, aux, _, _ in spy.updates]
        check(len(spy.updates) == updates, f"finetune {what}: {len(spy.updates)} updates, "
              f"expected {updates}")
        check(sum(n for n, _ in spy.passes) == microbatches
              and all(len(shapes) == 1 for _, shapes in spy.passes),
              f"finetune {what}: gradient passes {spy.passes}")
        check(bool(np.isfinite(losses).all()), f"finetune {what}: losses {losses}")
        fwd = n_layers * (2 * microbatches + spy.eval_batches) * on_card
        bwd = n_layers * microbatches * on_card
        check((counts["gated_relpos_attention"], counts["gated_relpos_attention_bwd"])
              == (fwd, bwd), f"finetune {what}: launches {counts}, expected {fwd} forwards and {bwd} backwards")
        check(counts["flash_mha"] == counts["whisper_log_mel"] == 0,
              f"finetune {what} launched a Whisper kernel: {counts}")
        out = results_accum if "--grad_accum" in args else results
        for name in ("finetune_results.json", "wavlm_finetune_weighted_sum_mlp_model.npz",
                     "wavlm_finetune_weighted_sum_mlp_info.json"):
            check((out / name).is_file(), f"finetune {what}: {name} missing")
        last = spy.updates[-(updates // epochs):]  # the last epoch, on the device timeline
        step_ms = [spy.ms(s, e) for s, e, *_ in last]
        epoch_ms = spy.ms(last[0][0], last[-1][1])
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
        say("finetune", run=what, updates=len(spy.updates), microbatches=microbatches,
            eval_batches=spy.eval_batches, first_loss=f"{losses[0]:.4f}",
            last_loss=f"{losses[-1]:.4f}", fwd_launches=counts["gated_relpos_attention"],
            bwd_launches=counts["gated_relpos_attention_bwd"],
            expected=f"{n_layers}x(2x{microbatches}+{spy.eval_batches}),{n_layers}x{microbatches}",
            last_epoch_ms_per_update=",".join(f"{t:.1f}" for t in step_ms),
            last_epoch_host_ms_per_update=",".join(f"{u[-1]:.1f}" for u in last),
            last_epoch_s=f"{epoch_ms / 1e3:.3f}",
            train_audio_s_per_s=f"{sum(u[3] for u in last) / (epoch_ms / 1e3):.1f}",
            cli_wall_s=f"{wall:.1f}", max_memory_gib=f"{peak:.2f}", card=f'"{card}"')
        return spy, counts

    spy, counts = run("epochs_2", ["--results_dir", str(results), "--checkpoint_dir", str(ckpt),
                                   "--epochs", "2"], 2, 2 * n_batches, 2 * n_batches)
    check(latest_step(str(ckpt)) == 2, f"checkpoints {latest_step(str(ckpt))}, expected step 2")
    trained = spy.trainers[0].params
    stem, *moving = watch
    check(torch.equal(trained[stem], spy.before[stem]), "the frozen stem moved")
    for name in moving:
        check(not torch.equal(trained[name], spy.before[name]), f"{name} did not move")

    resumed, _ = run("resume", ["--results_dir", str(results), "--checkpoint_dir", str(ckpt),
                                "--epochs", "3", "--resume"], 1, n_batches, n_batches)
    check(latest_step(str(ckpt)) == 3, "the resumed run wrote no step 3")
    for name in watch:  # the resumed run started from the 2-epoch state
        check(torch.equal(resumed.before[name], trained[name]), f"resume did not restore {name}")
    del spy, trained, resumed

    K = 2
    accum_updates = sum(math.ceil(n / K) for n in per_bucket)
    run("grad_accum_2", ["--results_dir", str(results_accum), "--epochs", "1",
                         "--grad_accum", str(K)], 1, accum_updates, K * accum_updates)
    return counts


def seeded_stem(torch, cfg):
    """WavLM-Large's conv stem in bf16 on the card: weights drawn like
    init_wavlm's, biases and norm affines given seeded noise so that every
    term of the epilogue is exercised."""
    from stutter_tpu_torch.models.wavlm import ConvFeatureEncoder

    g = torch.Generator().manual_seed(0)
    stem = ConvFeatureEncoder(cfg)
    with torch.no_grad():
        for layer in stem.layers:
            c_out, c_in, k = layer.weight.shape
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=g) * (c_in * k) ** -0.5)
            layer.bias.copy_(torch.randn(c_out, generator=g) * 0.1)
            layer.norm_scale.copy_(1.0 + 0.1 * torch.randn(c_out, generator=g))
            layer.norm_bias.copy_(0.1 * torch.randn(c_out, generator=g))
    return stem.to("cuda", torch.bfloat16)


def stem_flops_bytes(st, B: int, T: int, weights, table):
    """The fused stem's operations, the bytes of its inputs and output (each
    once), and the bytes the per-layer design also moves: each intermediate
    layer's bf16 frames written once and read once."""
    lengths = st.stem_layer_lengths(T)
    taps = (10,) + tuple(k * st.CHANNELS for k in (3, 3, 3, 3, 2, 2))
    flops = sum(2 * B * n * k * st.CHANNELS for n, k in zip(lengths, taps))
    io = 4 * B * T + 2 * weights.numel() + 4 * table.numel() + 2 * B * lengths[-1] * st.CHANNELS
    between = sum(2 * 2 * B * n * st.CHANNELS for n in lengths[:-1])
    return flops, io, between


def phase_stem(torch, card: str):
    """The fused stem kernel against its plain version, and its end-masked
    frames against the plain ConvFeatureEncoder (cuDNN, per-layer masking),
    at the 3 s and 30 s buckets with ragged lengths, a silent clip and a
    clip of 4 frames; median times of all three. Returns (worst max-abs
    error, the numbers at the 3 s bucket)."""
    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
    from stutter_tpu_torch.models.wavlm import WavLMConfig, wavlm_feature_lengths
    from stutter_tpu_torch.ops import wavlm_stem as st

    cfg = WavLMConfig.large()
    stem = seeded_stem(torch, cfg)
    weights, table = stem.packed()
    g = torch.Generator(device="cuda").manual_seed(3)
    worst, headline = 0.0, None
    for B, T in ((128, 51_280), (12, 481_360)):  # the 3 s and 30 s buckets
        lengths = torch.randint(T // 4, T + 1, (B,), device="cuda", generator=g)
        lengths[0], lengths[1], lengths[2] = T, T, 400 + 3 * 320  # full, silent, 4 frames
        wave = torch.randn(B, T, device="cuda", generator=g) * 0.1
        wave = wave * (torch.arange(T, device="cuda")[None] < lengths[:, None])
        wave[1] = 0.0
        wave = wavlm_prepare_batch(wave, lengths, cfg.do_normalize)
        out = st.wavlm_fused_stem(wave, weights, table)
        ref = st.wavlm_fused_stem_reference(wave, weights, table)
        lib = stem(wave, lengths)
        torch.cuda.synchronize()
        L = st.stem_frames_for_samples(T)
        check(out.shape == ref.shape == lib.shape == (B, L, 512) and out.dtype == torch.bfloat16,
              f"stem output {out.dtype} {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "stem output has non-finite values")
        d = out.float() - ref.float()
        max_abs = float(d.abs().max())
        nrmse = float(d.norm() / ref.float().norm())
        cos = cosine_distance(out.float(), ref.float())
        fl = wavlm_feature_lengths(cfg, lengths)
        keep = (torch.arange(L, device="cuda")[None] < fl[:, None])[:, :, None]
        masked = out.float() * keep
        lib_nrmse = float((masked - lib.float()).norm() / lib.float().norm())
        lib_cos = cosine_distance(masked, lib.float())
        ms, plain_ms, library_ms = time_turns(
            torch, lambda: st.wavlm_fused_stem(wave, weights, table),
            lambda: st.wavlm_fused_stem_reference(wave, weights, table),
            lambda: stem(wave, lengths))
        flops, io, between = stem_flops_bytes(st, B, T, weights, table)
        bound_ms, bound_by = bound(flops, io, BF16_FLOPS)
        design_ms, _ = bound(flops, io + between, BF16_FLOPS)
        say("stem", shape=f"{B}x{T}", frames=L, max_abs_err=f"{max_abs:.3e}",
            nrmse=f"{nrmse:.3e}", nrmse_tol=STEM_NRMSE, cosine_dist=f"{cos:.3e}",
            cosine_tol=STEM_COSINE, vs_convfeature_nrmse=f"{lib_nrmse:.3e}",
            vs_convfeature_cosine=f"{lib_cos:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{library_ms:.4f}", tflop=f"{flops / 1e12:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            bound_with_intermediates_ms=f"{design_ms:.4f}", card=f'"{card}"')
        check(nrmse <= STEM_NRMSE and cos <= STEM_COSINE,
              f"stem kernel disagrees with its plain version at {B}x{T}")
        check(lib_nrmse <= STEM_NRMSE and lib_cos <= STEM_COSINE,
              f"stem kernel disagrees with ConvFeatureEncoder at {B}x{T}")
        worst = max(worst, max_abs)
        if headline is None:
            headline = timing(ms, plain_ms, bound_ms, bound_by, library_ms)
        del out, ref, lib, masked, d
        torch.cuda.empty_cache()
    return worst, headline


def phase_stem_ab(torch, card: str) -> int:
    """cli.stem_fused_ab.main at its defaults (turbo) and with --preset fast:
    fidelity of the fused path against the f32 path and against the plain
    stem's, one stem launch per encode, the four timings. Returns the stem
    kernel's launches over both runs."""
    import io

    from stutter_tpu_torch.cli import stem_fused_ab

    zero_counts()
    for argv in ([], ["--preset", "fast"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = stem_fused_ab.main(argv)
        check(rc == 0, f"stem_fused_ab {argv} returned {rc}")
        r = json.loads(buf.getvalue().strip().splitlines()[-1])
        bar = TURBO_COSINE if r["preset"] == "turbo" else STEM_AB_FAST_COSINE
        fused, plain = r["fused_fidelity_vs_f32"], r["plain_fidelity_vs_f32"]
        say("stem_ab", preset=r["preset"], batch=f"{r['batch']}x{r['n_samples']}",
            fused_cosine_vs_f32=f"{fused:.3e}", plain_cosine_vs_f32=f"{plain:.3e}",
            bar=bar, ratio_bar=f"{STEM_AB_RATIO}x max(plain, {STEM_AB_FLOOR})",
            launches_per_encode=r["stem_launches_per_encode"],
            **{k: ",".join(f"{t:.3f}" for t in r[k])
               for k in ("stem_plain_ms", "stem_fused_ms", "e2e_plain_ms", "e2e_fused_ms")},
            e2e_plain_audio_s_per_s=f"{r['e2e_plain_audio_s_per_s']:.1f}",
            e2e_fused_audio_s_per_s=f"{r['e2e_fused_audio_s_per_s']:.1f}", card=f'"{card}"')
        check(r["stem_launches_per_encode"] == 1,
              f"{r['stem_launches_per_encode']} stem launches in one fused encode")
        check(fused <= bar, f"{r['preset']}: fused path {fused:.3e} from f32, bar {bar}")
        check(fused <= STEM_AB_RATIO * max(plain, STEM_AB_FLOOR),
              f"{r['preset']}: fused path {fused:.3e} from f32, plain path {plain:.3e}")
        torch.cuda.empty_cache()
    launches = read_counts()["wavlm_fused_stem"]
    check(launches > 0, "the stem A/B launched no stem kernel")
    return launches


def worst_pooled(a, b) -> float:
    """Worst cosine distance over the [S, B, D] pooled embeddings."""
    return max(cosine_distance(a[s, i], b[s, i])
               for s in range(a.shape[0]) for i in range(a.shape[1]))


def phase_turbo_fidelity(torch, name: str, embed, turbo_model, fast_model, fid_model):
    """One batch through the turbo, fast and f32 models (``embed(model)``
    gives pooled [S, B, D]): turbo's worst pooled cosine distance from f32
    (bar 2e-2, the JAX turbo tests'), fast's beside it."""
    from stutter_tpu_torch.ops.precision import no_tf32

    with no_tf32():
        ref = embed(fid_model)
    turbo, fast = embed(turbo_model), embed(fast_model)
    check(bool(torch.isfinite(turbo).all()), f"{name} turbo: non-finite pooled embeddings")
    d_turbo, d_fast = worst_pooled(turbo, ref), worst_pooled(fast, ref)
    say("turbo_fidelity", model=name, batch=f"{turbo.shape[1]}",
        turbo_cosine_vs_f32=f"{d_turbo:.3e}", fast_cosine_vs_f32=f"{d_fast:.3e}",
        bar=TURBO_COSINE)
    check(d_turbo <= TURBO_COSINE, f"{name} turbo {d_turbo:.3e} from f32, bar {TURBO_COSINE}")


@contextlib.contextmanager
def timed(phase: str):
    t0 = time.perf_counter()
    yield
    say("time", of=phase, seconds=f"{time.perf_counter() - t0:.1f}")


def main() -> int:
    if not (ROOT / "stutter_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout holding stutter_tpu_torch/",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import logging

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    logging.basicConfig(level=logging.WARNING)

    from stutter_tpu_torch.extract.pipeline import WavLMExtractor, WhisperExtractor
    from stutter_tpu_torch.frontend.whisper_frontend import whisper_features
    from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
    from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel
    from stutter_tpu_torch.ops import _build
    from stutter_tpu_torch.ops import attn_probes as probes
    from stutter_tpu_torch.ops import flash_mha as mha
    from stutter_tpu_torch.ops import logmel
    from stutter_tpu_torch.ops import wavlm_attention as attn
    from stutter_tpu_torch.weights.convert import init_wavlm, init_whisper

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    say("device", name=f'"{torch.cuda.get_device_name(0)}"', count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    with timed("build"):
        lib, build_s = _build.build()
    say("build", seconds=f"{build_s:.2f}", library=lib.relative_to(ROOT))

    try:
        with timed("kernel"):
            wavlm_err, wavlm_times = phase_kernel(torch, attn)
        with timed("attn_bwd"):
            bwd_err, bwd_rel, bwd_times = phase_attn_bwd(torch, attn, card)
        with timed("logmel"):
            logmel_err, logmel_times = phase_logmel(torch, logmel)
        with timed("mha"):
            mha_err, mha_times = phase_mha(torch, mha)
        with timed("mha_bias"):
            mha_bias_err, mha_bias_times = phase_mha_bias(torch, mha)
        with timed("probe_kernels"):
            probe_numbers = phase_probe_kernels(torch, probes, card)
        with timed("probes"):
            probe_counts = phase_probes(torch, card)
        with timed("stem"):
            stem_err, stem_times = phase_stem(torch, card)

        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            with timed("wavlm_init"):
                cfg = WavLMConfig.large()
                base = init_wavlm(cfg, torch.Generator().manual_seed(0))
                fid_model = WavLMModel(cfg, device="cuda")
                fid_model.load_state_dict(base.state_dict())
                extractor = WavLMExtractor(base, "cuda", preset="fast")  # casts to bf16
                # turbo from the same f32 weights: bf16 cast, then int8 projections
                turbo = WavLMExtractor(copy.deepcopy(fid_model), "cuda", preset="turbo")
            with timed("slice"):
                wavlm_counts = phase_slice(torch, extractor, work)
            with timed("path"):
                phase_kernel_path_vs_plain(torch, attn, extractor.layer_indices,
                                           extractor.model, fid_model)
            with timed("long_slice"):
                long_counts = phase_long_slice(torch, extractor, work)
            with timed("turbo_slice"):
                phase_slice(torch, turbo, work, phase="turbo_slice")
                wave, lengths = wavlm_test_batch(torch, extractor.cfg)
                phase_turbo_fidelity(
                    torch, "wavlm-large",
                    lambda m: m.encode(wave, extractor.layer_indices, lengths),
                    turbo.model, extractor.model, fid_model)
            del fid_model
            with timed("throughput"):
                fast_rate = phase_throughput(torch, extractor, work, card)
                turbo_rate = phase_throughput(torch, turbo, work, card)
            say("turbo", model="wavlm-large", fast_audio_s_per_s=f"{fast_rate:.1f}",
                turbo_audio_s_per_s=f"{turbo_rate:.1f}",
                turbo_over_fast=f"{turbo_rate / fast_rate:.3f}", card=f'"{card}"')
            del extractor, turbo, base
            torch.cuda.empty_cache()
            with timed("stem_ab"):
                stem_launches = phase_stem_ab(torch, card)

            with timed("whisper_init"):
                cfg = WhisperConfig.large()
                base = init_whisper(cfg, torch.Generator().manual_seed(0))
                fid_model = WhisperModel(cfg, device="cuda")
                fid_model.load_state_dict(base.state_dict())
                extractor = WhisperExtractor(base, "cuda", preset="fast")  # casts to bf16
                del base
            with timed("whisper_slice"):
                whisper_counts = phase_whisper_slice(torch, extractor, work)
            with timed("whisper_path"):
                phase_whisper_path(torch, extractor.model, fid_model)
            with timed("whisper_turbo_slice"):
                turbo = WhisperExtractor(copy.deepcopy(fid_model), "cuda", preset="turbo")
                phase_whisper_slice(torch, turbo, work, phase="whisper_turbo_slice")
                mel = whisper_features(whisper_test_clips(torch, 16, seed=5))
                idx = extractor.encoder_indices
                phase_turbo_fidelity(torch, "whisper-large", lambda m: m.embed(mel, idx, idx),
                                     turbo.model, extractor.model, fid_model)
                del mel
            del fid_model
            torch.cuda.empty_cache()
            with timed("whisper_throughput"):
                fast_rate = phase_whisper_throughput(torch, extractor, work, card)
                turbo_rate = phase_whisper_throughput(torch, turbo, work, card)
            say("turbo", model="whisper-large", fast_clips_per_s=f"{fast_rate:.2f}",
                turbo_clips_per_s=f"{turbo_rate:.2f}",
                turbo_over_fast=f"{turbo_rate / fast_rate:.3f}", card=f'"{card}"')
            del extractor, turbo
            torch.cuda.empty_cache()

            with timed("finetune_path"):
                phase_finetune_path(torch, attn, WavLMConfig.large())
            torch.cuda.empty_cache()
            with timed("finetune"):
                ft_counts = phase_finetune(torch, work, card)
    except CheckFailed as e:
        print(f"FAILED: {e}", flush=True)
        return 1

    kernels = [  # name, source, replaces, launches on its path, max-abs error, numbers
        ("gated_relpos_attention", "wavlm_attention.cu",
         "stutter_tpu/ops/wavlm_attention_pallas.py:31",
         wavlm_counts["gated_relpos_attention"], wavlm_err, wavlm_times),
        ("gated_relpos_attention_bwd", "wavlm_attention_bwd.cu",
         "stutter_tpu/ops/wavlm_attention_vjp.py:145", ft_counts["gated_relpos_attention_bwd"],
         bwd_err, bwd_times),
        ("whisper_log_mel", "logmel.cu", "stutter_tpu/ops/logmel_pallas.py:43",
         whisper_counts["whisper_log_mel"], logmel_err, logmel_times),
        ("flash_mha", "flash_mha.cu", "stutter_tpu/models/attention.py:54",
         whisper_counts["flash_mha"], mha_err, mha_times),
        ("wavlm_fused_stem", "wavlm_stem.cu", "stutter_tpu/ops/wavlm_stem_pallas.py:113",
         stem_launches, stem_err, stem_times),
        ("flash_mha_bias", "flash_mha.cu", "stutter_tpu/models/attention.py:102",
         long_counts["flash_mha_bias"], mha_bias_err, mha_bias_times),
        ("attn_int8", "attn_probes.cu", "scripts/attn_int8_probe.py:66",
         probe_counts["attn_int8"], *probe_numbers["attn_int8"]),
        ("attn_softmax_variants", "attn_probes.cu", "scripts/attn_softmax_variants_probe.py:54",
         probe_counts["attn_softmax_variants"], *probe_numbers["attn_softmax_variants"]),
    ]
    line = [{"name": name, "route": "cuda", "source": f"stutter_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches, "max_abs_err": err, **times}
            for name, source, replaces, launches, err, times in kernels]
    line[0]["also_replaces"] = "stutter_tpu/ops/wavlm_attention_pallas.py:93"
    line[0]["finetune_launches"] = ft_counts["gated_relpos_attention"]
    line[1]["also_replaces"] = ["stutter_tpu/ops/wavlm_attention_vjp.py:68",
                                "stutter_tpu/ops/wavlm_attention_vjp.py:115"]
    line[1]["max_rel_err"] = bwd_rel
    line[6]["also_replaces"] = "scripts/attn_int8_probe.py:100"  # its pallas_call
    line[7]["also_replaces"] = "scripts/attn_softmax_variants_probe.py:98"
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
