#!/usr/bin/env python3
"""Run the PyTorch port's WavLM-Large and Whisper-large extraction (fidelity,
fast, turbo), WavLM's long-bucket escape hatch, the two attention probes,
the fused WavLM stem, WavLM-Large fine-tuning, the downstream classifier
stack, HF checkpoint loading, the chunk long-file policy, serving, the host
audio runtime, fine-tuning's remat policies and int8_forward, Whisper's
shifted-GEMM stem, the process groups of data and tensor parallelism, the
turbo_ffn preset, Whisper large-v3, the combined server, cli.train's Whisper
re-extraction and the utils (per-run logfile, profiler trace, FLOP models)
on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --only-parallel   # [slice], [parallel], then [chunk] and
                                 # [parallel_serve] (with two cards or more: NCCL
                                 # world 2, DP scaling, serving over NCCL)

Phases, one line each on stdout ([time] lines give each phase's seconds):
1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from stutter_tpu_torch/csrc (nvcc, sm_90a,
   one process per source);
3. kernel: the WavLM attention kernel against its plain PyTorch version on
   the card, at the extraction path's shapes (3 s, 20 s and 30 s buckets),
   at lengths around the bf16 tiles' 64- and 128-row edges and a ragged
   length, with masks that cut clips short and a fully padded clip: errors
   against stated tolerances, median times per launch and, in bf16, with 8
   launches queued;
3b. attn_bwd: the WavLM attention backward kernels (and the forward's row
   statistics) against the plain backward, bf16 and f32, at the fine-tune
   CLI's 3 s and 10 s batches and a ragged L = 1008, with a fully padded
   clip: per gradient the max-abs error over the plain result's max and the
   cosine distance, two calls bit-equal, median times per launch and, in
   bf16, with 8 launches queued; beside them, as a yardstick for dq, dk and
   dv alone, the maskless bf16 backward of scaled_dot_product_attention;
4. logmel: the Whisper log-mel kernel against its plain version and the
   float64 log-mel at 16 x 30 s (80 and 128 mels; silent, quiet and
   zero-padded clips among them), timed per launch and 8 queued, and
   untimed at 1 and 17 clips with a pure tone and a loud burst in 1e-6
   noise;
5. mha: the Whisper encoder's flash-attention kernel against its plain
   version at 16 x 20 x 1500 x 64 in bf16 and f32, with key padding and at a
   ragged length; scaled_dot_product_attention timed beside it; and what
   ptxas said of the bf16 wgmma kernels, every instantiation of the
   forward tiles, of the backward, of the stem's conv layers and of the
   positional conv (registers, spills, serialised wgmma);
5a. mha_bias: the materialised-bias flash kernel (WavLM's escape hatch)
   against its plain version at 12 x 16 x 1504 x 64 and 19 x 16 x 1008 x 64
   in bf16 with keys masked, and f32 at a ragged length;
   scaled_dot_product_attention with the same bias timed beside it;
5a1. relkey_attn: w2v-BERT's relative-key attention kernel against its
   plain version at 8 x 16 x 1499 x 64 and 12 x 16 x 999 x 64 (the 30 s and
   20 s buckets; the second with keys masked), at 1504 and 1008, bf16 and
   f32, timed per launch and 8 queued beside the plain version and
   scaled_dot_product_attention given the materialised bias, and untimed at
   ragged lengths around the 64-row tiles with key counts of 1, 63, 64, 65
   and L (``--only-relkey``: this phase and the next alone, after the build
   and ptxas's report);
5a1b. w2v_bert_slice: w2v-BERT 2.0 at its published widths through
   W2VBertExtractor (fast) on one 12 x 20 s and one 8 x 30 s batch: 24
   relative-key launches a batch, 144 norms (96 fused) and no other kernel,
   and the pooled rows against the same batch with the norm's and the
   attention's gates closed;
5a2. mha_edges: both kernels' bf16 wgmma tiles at their edges (flash_mha
   at head_dim 64 and 120), checked and not timed: L of 37, 64, 65, 127,
   128, 129, 1008, 1500 and 1504 with key counts of 0, 1, 63, 64, 65 and L,
   ab through its 16-byte and its element-wise copies, a contiguous
   [B, H, L, 64] input, 70,000 blocks;
5a3. gated_edges: the WavLM attention's bf16 wgmma tiles in both grid
   orders, output and row statistics, checked and not timed: L of 37, 63,
   64, 65, 127, 128, 129, 160 and 1008 with a full, a half, a fully padded
   and a zero-gate clip, the bias through its 16-byte and its element-wise
   copies, a contiguous input;
5a4. bwd_edges: the bf16 backward's wgmma kernels against the plain
   backward, checked and not timed: L of 37, 63, 64, 65, 127, 128, 129, 160,
   512 and 1008 with a full, a half, a fully padded and a zero-gate clip,
   both grid orders, one and two clip groups in the dbias kernel, the f32
   planes through 16-byte and element-wise copies, a contiguous input;
5b. probe_kernels: the int8 probe's kernels (int8 k and v and their scales
   bit-equal to the plain version's) and the four softmax variants against
   their plain versions at 25 x 16 x 1504 x 64, 30 x 16 x 1008 x 64 and
   the ragged lengths 37, 64, 65, 129 and 1025 (64 k + 1);
5c. probes: cli.attn_int8_probe and cli.attn_softmax_variants_probe at
   their defaults, in-process: their JSON, fidelity against f32, launches,
   and the verdicts on this card (int8's speedup_min over the bf16 kernel,
   each variant's best ms over the incumbent's);
5d. stem: the fused WavLM stem kernels against their plain version and the
   plain ConvFeatureEncoder (cuDNN) at 128 x 3 s and 12 x 30 s (timed per
   launch and 8 queued), with ragged lengths, a silent clip and a clip of 4
   frames, and untimed at one clip, a one-frame clip (T = 400), an
   unaligned length and 1 s clips, whose last layers leave a CTA of a
   cluster with no rows;
5d'. pos_conv: the positional conv kernel (hidden + the grouped conv's
   embedding in one launch) against its plain version, an f32 reference and
   the cuDNN path it replaced, at WavLM-Large's 3, 20 and 30 s buckets and
   XLS-R 2B's 20 and 30 s ones (timed per launch and 8 queued, with the
   bound), and untimed at the edges of its 256-frame tiles and 64-row
   sub-tiles (L = 1 ... 257) with clips' tails zeroed at odd counts;
5d''. layer_norm: the layer norm kernel, alone and with the residual add in
   front of it, against its plain version and F.layer_norm at the main
   path's shapes (WavLM-Large, XLS-R 2B and Whisper-large widths and the
   feature projection's 512; per launch, and 8 queued over inputs larger
   than the L2, with the bound from bytes) and untimed at 1 and 3 rows and
   edge rows (constant, +-1e4, 1e-3, zeroed padding): the sum bit-equal, the
   outputs within a bf16 step, the share flipped, and bit-equal at rows whose
   statistics are exact in any order; then a WavLM-Large and an
   XLS-R 2B batch through encode: 50 and 98 launches, the pooled rows
   against the same batch with the gate closed;
5e. decode: the host audio runtime (audio/csrc/wavio.cpp, ffdecode.cpp,
   built with g++ into build/): its build seconds, whether libav was found,
   os.cpu_count(); the native parser bit-equal to the numpy plain version on
   every format of tests/test_audio_robustness.py; decode_batch (the C++
   thread pool, 1 thread and the default) against decode_batch_plain on 128
   x 3 s at 16 kHz and 44.1 kHz (resampled): median ms per batch of 5;
6. slice: a synthetic 16 kHz corpus through ExtractionPipeline.run with
   WavLM-Large (random weights, seed 0) in the fast preset; checks the store,
   the checkpoints, that every attention call went through the kernel, 50
   layer norm launches a batch, and that a resumed run skips finished rows;
6b. decode_flac: with libav, the slice's corpus and its FLAC copy through
   ExtractionPipeline with one batcher's settings: store rows bit-equal, 24
   gated launches a batch (without libav a line saying so);
7. path: one 3 s bucket batch through WavLMModel.encode with the kernel and
   with the plain attention, in the fast and the fidelity preset;
7a. long_slice: clips of the 3 s, 20 s and 30 s buckets through
   ExtractionPipeline.run with long_attention "gated" and
   "materialized_bias": exact launch counts of both kernels, the store, and
   the pooled distance between the two runs;
7b. turbo_slice: the slice again in turbo (6 int8 GEMMs per layer and
   batch, the fused stem once a batch), then turbo's pooled distance from
   the f32 path on one frame-aligned batch, through the fused stem;
7c. turbo_ffn_slice: the slice in turbo_ffn from the same f32 weights (2
   int8 GEMMs per layer and batch, the FFN's), and its distance from f32;
8. throughput: WavLM extraction's audio-seconds per second over 1280 clips
   of 2-3 s, after a warm batch, and one batch's device time, fast and turbo,
   with its MFU (utils.benchmarking's FLOP model at the bf16 peak);
9. whisper_slice: a synthetic corpus through a default-constructed
   ExtractionPipeline with Whisper-large (random weights, seed 0, fast):
   the store, the checkpoints, one log-mel launch per batch and 32 attention
   launches per batch, and resume;
10. whisper_path: one 16 x 30 s batch through the kernel path and the plain
   path (plain log-mel and attention), in both presets;
10a. whisper_gemm_stem: the same fast batch with the stem as three shifted
   GEMMs (gemm_stem) against the conv stem: pooled rows within 5e-4, the
   stem's ms each way, one log-mel call and 32 attention launches;
10b. whisper_turbo_slice: the Whisper slice in turbo (5 int8 GEMMs per
   encoder layer and batch, none in the decoder) and turbo's distance from
   the f32 path on the 16 x 30 s batch;
10c. whisper_turbo_ffn_slice: the same in turbo_ffn (2 int8 GEMMs per
   encoder layer and batch);
11. whisper_throughput: 64 clips of 2-3 s in batches of 16, after a warm
   batch: clips/s, audio-s/s, one batch's device time and the encoder's MFU,
   fast and turbo;
11b. whisper_v3_slice: Whisper large-v3 (128 mels) through the pipeline
   (one log-mel call, 32 flash_mha launches a batch), then a 16 x 30 s batch
   against the f32 plain path (encoder 1e-3, decoder 5e-4);
12. finetune_path: one fixed WavLM-Large training step at 8 x 3 s through
   the kernels and through the plain attention, bf16 and f32: the loss and
   the gradient cosine distance per group (encoder, layer weights, head);
12b. finetune_policies: WavLM-Large 8 x 3 s bf16 from one state, for each
   remat policy (layer, layer_dots, layer_probs, dots, nothing) and layer
   with int8_forward: one gradient pass (launches, int8 products) and two
   updates (ms, peak memory); gradients per group within 1e-3 of layer's;
   int8_forward's cosine distance and norm ratio against the bf16 step, and
   its kernel path within 1e-3 of its plain path;
13. finetune: stutter_tpu_torch.cli.finetune.main on a synthetic labeled
   corpus (128 clips of 2-3 s and 6 of 8-10 s to train on) at WavLM-Large:
   2 epochs with checkpoints, a --resume run for a third, a --grad_accum 2
   run; losses, parameters, launch counts (per-layer remat: 2 forwards and
   1 backward per layer per microbatch, 1 forward per eval batch), resume,
   outputs, ms per update, training audio-s/s, peak memory;
14. downstream_dsp: resample (six rate pairs) and pitch_shift (+-2) on the
   card against the committed float64 goldens and the CPU tensor path;
   augment_audio's ms per clip over 256 clips of 3 s, per kind;
15. downstream_heads: a KSF-scale training split (4,096 x 1,024, 8 classes,
   the largest 25x the smallest): SMOTE on the card against the CPU with
   the same draws (values, neighbour indices), a 3-epoch head fit on the
   card against the CPU, the default MLP's seconds and held-out balanced
   accuracy on the balanced set;
16. downstream: cli.extract_wavlm then cli.train (MLP, augmentation factor
   2, threshold 20) on a KSF-layout corpus at WavLM-Large, then
   run_grid_training with the two heads: launches of the re-extraction (24
   a batch), 64 augmented rows, SMOTE's balance, the JAX package's output
   tree, balanced accuracies, seconds per stage;
17. checkpoint: WavLM-Large (24 layers) and Whisper-large widths at 4 + 4
   layers from the seeded init, written as HF checkpoint directories (a
   hand-written model.safetensors; a pytorch_model.bin with weight_g/weight_v
   names), loaded by load_wavlm / load_whisper and verify_* on the card:
   every tensor and one fast batch's pooled embeddings bit-equal, the
   safetensors files also parsed with the package hidden; the write, load
   and verify seconds;
18. chunk: ExtractionPipeline with long_files "chunk" over 8 clips of 3-8 s
   and 3 of 41-75 s with the loaded WavLM: the long rows against
   chunked_embeddings, 24 gated launches per batch, audio-s/s;
19. serve: EmbeddingServer over the loaded WavLM with a ServingClassifier
   (an MLP head run_balanced_training fits on the chunk store): 96 JSONL
   requests (two 41 s clips, one undecodable file), then 8 POSTs, /stats and
   /healthz on the HTTP frontend: each request answered once, only the bad
   file failing, rows within 1e-3 of the pipeline's, the predictions
   load_model's, 24 gated launches per batch; p50/p95 latency (beside PR
   11's on the numpy decoder), device_s_per_audio_s, audio-s/s; with libav,
   a FLAC POST answered 200 with the WAV POST's row;
20. parallel (after the Whisper phases, from the fast states they leave):
   a one-rank NCCL group through make_plan ([slice]'s rows and two
   data-parallel fine-tune steps bit-equal to the plain runs; audio-s/s with
   and without the group); two gloo ranks (card 0 shared on one card) for
   WavLM-Large at TP = 2 (16 x 3 s, 2 x 30 s) and Whisper-large at TP = 2
   (4 x 30 s), each rank's kernels at 8 and 10 heads (launches, heads,
   contiguous bias planes), and a DP = 2 extraction of 64 clips, within the
   kernel-vs-plain bar of the one-process run; dryrun_multichip(2,
   backend="gloo"); with two cards or more, the same over NCCL and the
   data-parallel audio-s/s at 1 and 2 cards;
21. parallel_serve (after serve): cli.serve, cli.predict and cli.train at
   --devices 2 with WavLM-Large from the [checkpoint] directory and the
   [serve] head, two gloo ranks sharing the card: serve over JSONL at DP = 2
   and TP = 2 (48 requests, a 41 s clip, an undecodable file) against the
   one-process EmbeddingServer, predict over the [chunk] corpus and train
   with augmentation against --devices 1; each rank's launches (24 a
   batch), rows and probabilities within 1e-4, rank 1 writing no file; with
   two cards or more, serve over NCCL: p50/p95 and audio-s/s beside the
   one-process server's;
22. serve_combined: cli.serve --model_type combined over the [checkpoint]
   WavLM-Large and 4 + 4-layer Whisper-large directories: the fusion store's
   columns, each within 1e-4 of its part's extractor alone, the launches;
23. train_whisper: cli.train --model_type whisper with augmentation on a
   small Whisper store: the re-extraction's log-mel and flash_mha launches,
   the store's first batch re-extracted unchanged within 1e-4 of its rows;
24. utils (last, so that no timing follows a profiler session): one fast
   batch of the slice's corpus inside annotate("encode") under
   utils.profiling.trace: the Chrome trace holds the range and the gated
   kernel once a layer under its CUDA name; the host's microseconds to
   enqueue a small kernel before and after the traces.
Every CLI run here starts from a working directory of its own and must
leave exactly one logfile there (utils.logging; [utils] counts them).
Each extraction, probe, fine-tune, downstream, chunk, serving and parallel
path is driven with every kernel's launch count (and the int8 GEMM count)
set to 0 just before it and read just after. Then one JSON line with the
kernels' numbers (time, plain time, bound, library time, launches on their
path) and, last, the device line.
Any failed check exits non-zero; with no CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import copy
import csv
import json
import os
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
# pooled embeddings of the fast kernel path against the f32 plain path: the
# repo's bar (Whisper's decoder columns: WHISPER_FAST_DECODER_COSINE)
FAST_F32_POOLED_COSINE = 1e-3
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

# the fused stem against its plain version, and the kernel path's end-masked
# frames against the plain ConvFeatureEncoder: the JAX test's bars
# (tests/test_stem_pallas.py:98-102). Both share the rounding points (conv ->
# bf16, bias in bf16, f32 statistics, tanh GELU on bf16) but sum in another
# order, and one flipped bf16 rounding propagates through seven layer norms.
STEM_COSINE, STEM_NRMSE = 5e-4, 0.03
# turbo's pooled embeddings against the f32 path: the JAX turbo tests' bar
# (tests/test_quant.py:153,184)
TURBO_COSINE = 2e-2
# int8 GEMMs a layer and batch, by preset
INT8_GEMMS_A_LAYER = {"wavlm": {"turbo": 6, "turbo_ffn": 2},
                      "whisper": {"turbo": 5, "turbo_ffn": 2}}


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


def reset_port_logging() -> None:
    """The port's logging as a new process finds it: ``utils/logging.py``
    configures it once a process, and each CLI run here is to start its own
    logfile and leave no handler behind."""
    import logging

    from stutter_tpu_torch.utils import logging as port_logging

    logger = logging.getLogger("stutter_tpu_torch")
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()
    logger.setLevel(logging.NOTSET)
    port_logging._configured = False
    port_logging.inherit_logfile(None)


CLI_LOGFILES: list[str] = []  # the logfile each CLI run here left


@contextlib.contextmanager
def cli_dir(work: Path, tag: str):
    """Run a CLI (in this process, or on the ranks it spawns) from a new
    working directory under ``work`` with the port's logging unset; then check
    that the run left exactly one logfile there, ``logs/{tag}_*.log``."""
    cwd = work / f"cli_{len(CLI_LOGFILES):02d}_{tag}"
    cwd.mkdir()
    home = os.getcwd()
    reset_port_logging()
    os.chdir(cwd)
    try:
        yield cwd
    finally:
        os.chdir(home)
        reset_port_logging()
    logs = sorted(p.name for p in (cwd / "logs").iterdir()) if (cwd / "logs").is_dir() else []
    check(len(logs) == 1 and logs[0].startswith(f"{tag}_") and logs[0].endswith(".log"),
          f"{tag}: the run left the logfiles {logs}, expected one {tag}_*.log")
    CLI_LOGFILES.append(logs[0])


KSF_LABELS = ("no_disfluency", "block", "prolongation", "sound_repetition")
_CORPORA: dict[Path, float] = {}  # corpora written in this run: their audio seconds


def write_corpus(root: Path, n_per_split: dict, dur_range, seed: int,
                 long_per_split: dict | None = None, long_range=(8.2, 9.8),
                 labels: dict | None = None) -> float:
    """KSF layout: wav/{split}_{i}.wav at 16 kHz plus lab/{split}.csv, clips
    of ``dur_range`` seconds (or ``dur_range[split]``, given a dict), with
    ``long_per_split[split]`` more clips of ``long_range`` seconds; each
    clip's label drawn at random, or ``labels[split][i]``. Returns the total
    audio seconds; a corpus already written at ``root`` is reused."""
    import numpy as np

    if root in _CORPORA:
        return _CORPORA[root]

    from stutter_tpu_torch.audio.wavio import write_wav

    rng = np.random.RandomState(seed)
    (root / "wav").mkdir(parents=True)
    (root / "lab").mkdir()
    total = 0.0
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
            drawn = KSF_LABELS[rng.randint(len(KSF_LABELS))]
            rows.append((name, labels[split][i] if labels else drawn))
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
    from stutter_tpu_torch.utils.benchmarking import bound

    cases = [  # (B, H, L, dtype, layout): the main path passes [B, L, H, d] views
        (128, 16, 160, torch.bfloat16, "blhd"),   # 3 s bucket, fast preset
        (12, 16, 1504, torch.bfloat16, "blhd"),   # 30 s bucket, fast preset
        (19, 16, 1008, torch.bfloat16, "blhd"),   # 20 s bucket, fast preset
        (128, 16, 160, torch.float32, "blhd"),    # 3 s bucket, fidelity preset
        (12, 16, 1504, torch.float32, "blhd"),    # 30 s bucket, fidelity preset
        (4, 16, 160, torch.float32, "blhd"),
        (5, 16, 37, torch.bfloat16, "bhld"),      # ragged L, contiguous
        (5, 16, 37, torch.float32, "bhld"),
    ] + [(6, 16, L, torch.bfloat16, "blhd")       # the bf16 tiles' 64- and 128-row edges
         for L in (63, 64, 65, 127, 128, 129)]
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
        if dtype == torch.bfloat16:  # 8 launches enqueued back to back: the device's time
            numbers["queued_ms"], = time_turns(
                torch, lambda: attn.gated_relpos_attention(*args), reps=8)
        say("kernel", shape=f"{B}x{H}x{L}x64", dtype=str(dtype).split(".")[-1],
            layout=layout, max_abs_err=f"{max_abs:.3e}", max_abs_tol=tol_abs,
            cosine_dist=f"{cos:.3e}", cosine_tol=tol_cos, **shown(numbers))
        check(max_abs <= tol_abs and cos <= tol_cos,
              f"kernel disagrees with its plain version at {B}x{H}x{L} {dtype}")
        worst_abs = max(worst_abs, max_abs)
        headline = headline or numbers
        del q, k, v, bias, gate, mask, args, out, ref
        torch.cuda.empty_cache()
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
    from stutter_tpu_torch.utils.benchmarking import BF16_PEAK, F32_PEAK

    return BF16_PEAK if dtype == torch.bfloat16 else F32_PEAK


def make_qkv(torch, g, B, H, L, dtype, transposed=True, d=64):
    """q, k, v (randn * 0.5 in ``dtype``) as [B, L, H, d] projections viewed
    [B, H, L, d], as the models pass them, or contiguous [B, H, L, d]."""
    def one():
        if transposed:
            return (torch.randn(B, L, H, d, device="cuda", generator=g) * 0.5).to(dtype) \
                .transpose(1, 2)
        return (torch.randn(B, H, L, d, device="cuda", generator=g) * 0.5).to(dtype)
    return one(), one(), one()


def attention_inputs(torch, g, B, H, L, dtype, lengths, transposed=True):
    """q, k, v of ``make_qkv``, bias [H, L, L], gate [B, H, L] in [0, 2) and
    the key mask of `lengths`."""
    q, k, v = make_qkv(torch, g, B, H, L, dtype, transposed)
    bias = torch.randn(H, L, L, device="cuda", generator=g)
    gate = torch.rand(B, H, L, device="cuda", generator=g) * 2
    mask = torch.where(torch.arange(L, device="cuda")[None] < lengths[:, None],
                       0.0, -1e9).float().contiguous()
    return q, k, v, bias, gate, mask


def sdpa_backward(torch, q, k, v, do):
    """One backward of the maskless bf16 ``scaled_dot_product_attention`` on
    these inputs, its forward run once beforehand: the yardstick for dq, dk
    and dv alone."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, scale=1.0)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def phase_attn_bwd(torch, attn, card: str):
    """Backward kernels against the plain backward, and two calls bit-equal;
    returns (worst max-abs error, the worst of it relative to the plain
    result's max, the numbers at the CLI's 3 s batch in bf16)."""
    from stutter_tpu_torch.utils.benchmarking import bound

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
            again = attn.gated_relpos_attention_backward(*args, out, do, stats)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"two backward calls differ at {B}x{H}x{L} {dtype}")
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
            if dtype == torch.bfloat16:  # 8 launches enqueued back to back: the device's time
                numbers["queued_ms"], = time_turns(
                    torch, lambda: attn.gated_relpos_attention_backward(*args, out, do, stats),
                    reps=8)
            say("attn_bwd", shape=f"{B}x{H}x{L}x64", dtype=str(dtype).split(".")[-1],
                **{f"{k}_rel_cos": v for k, v in fields.items()},
                rel_tol=tol_rel, cosine_tol=tol_cos, stats_max_abs=f"{stats_err:.2e}",
                bit_equal_calls=True, **shown(numbers), card=f'"{card}"')
            if dtype == torch.bfloat16:
                # a yardstick for dq, dk and dv alone, not the library column:
                # the maskless bf16 backward of scaled_dot_product_attention
                # computes neither dgate nor dbias
                yard, = time_turns(torch, sdpa_backward(torch, *args[:3], do))
                yard_q, = time_turns(torch, sdpa_backward(torch, *args[:3], do), reps=8)
                say("attn_bwd", shape=f"{B}x{H}x{L}x64", dtype="bfloat16",
                    yardstick="sdpa_maskless_backward", ms=f"{yard:.4f}",
                    queued_ms=f"{yard_q:.4f}", card=f'"{card}"')
            headline = headline or numbers
    return worst_abs, worst, headline


def time_turns(torch, *fns, runs: int = 20, reps: int = 1):
    """Median ms per launch of each function, timed with CUDA events, in
    turns. With ``reps`` 1 the events enclose one launch and the host's time
    to enqueue it; with more, that many launches enqueued back to back, which
    hides the host behind the device as a model's layers do."""
    for _ in range(3):
        for fn in fns:
            fn()
    times = tuple([] for _ in fns)
    for _ in range(runs):
        for fn, acc in zip(fns, times):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            e1.synchronize()
            acc.append(e0.elapsed_time(e1) / reps)
    return tuple(sorted(t)[len(t) // 2] for t in times)


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
    from stutter_tpu_torch.ops.layer_norm import add_layer_norm
    from stutter_tpu_torch.ops.logmel import whisper_log_mel
    from stutter_tpu_torch.ops.pos_conv import pos_conv_residual
    from stutter_tpu_torch.ops.wavlm_attention import (
        gated_relpos_attention,
        gated_relpos_attention_backward,
    )
    from stutter_tpu_torch.ops.relkey_attention import relkey_attention
    from stutter_tpu_torch.ops.wavlm_stem import wavlm_fused_stem

    return {"gated_relpos_attention": gated_relpos_attention,
            "gated_relpos_attention_bwd": gated_relpos_attention_backward,
            "flash_mha": flash_mha, "whisper_log_mel": whisper_log_mel,
            "wavlm_fused_stem": wavlm_fused_stem, "pos_conv_residual": pos_conv_residual,
            "flash_mha_bias": flash_mha_bias, "layer_norm": add_layer_norm,
            "relkey_attention": relkey_attention,
            "attn_int8": int8_attention_long, "attn_softmax_variants": softmax_variant_attention}


def zero_counts() -> None:
    """Every kernel's launch count, the layer norm's fused launches and the
    int8 GEMM count, to 0."""
    from stutter_tpu_torch.ops.layer_norm import add_layer_norm
    from stutter_tpu_torch.ops.quant import qdot

    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0
    add_layer_norm.launches_fused = 0
    qdot.calls = 0


def read_counts() -> dict:
    from stutter_tpu_torch.ops.layer_norm import add_layer_norm
    from stutter_tpu_torch.ops.quant import qdot

    counts = {name: wrapper.launches for name, wrapper in kernel_wrappers().items()}
    counts["layer_norm_fused"] = add_layer_norm.launches_fused
    counts["int8_gemm"] = qdot.calls
    return counts


# the layer norm's launch counts, which the checks of whole runs leave to
# ``check_layer_norms``
LN_COUNTS = ("layer_norm", "layer_norm_fused")


def check_layer_norms(what: str, counts: dict, n_layers: int, batches: int) -> None:
    """A bf16 pre-LN encoder's norms on the card: per batch 2 a layer (the
    first norm, then the residual add and the second norm fused), the final
    norm and the feature projection's."""
    want = ((2 * n_layers + 2) * batches, n_layers * batches)
    check(tuple(counts[k] for k in LN_COUNTS) == want,
          f"{what}: layer norm launches {tuple(counts[k] for k in LN_COUNTS)} "
          f"(all, fused), expected {want}")


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


def check_wavlm_kernels(what: str, counts: dict, batches: int, on_card: bool,
                        n_layers: int) -> None:
    """A bf16 WavLM run's kernels beside the gated attention: the positional
    conv once a batch, the fused stem at most once (frame-aligned buckets
    take it), the layer norms (``check_layer_norms``), and no other kernel."""
    check(counts["pos_conv_residual"] == batches * on_card,
          f"{what}: {counts['pos_conv_residual']} positional conv calls for {batches} batches")
    check(counts["wavlm_fused_stem"] <= batches * on_card,
          f"{what}: {counts['wavlm_fused_stem']} fused stem calls for {batches} batches")
    check_layer_norms(what, counts, n_layers, batches * on_card)
    check(not any(v for k, v in counts.items() if k not in (
        "gated_relpos_attention", "pos_conv_residual", "wavlm_fused_stem", *LN_COUNTS)),
          f"{what}: other kernels launched: {counts}")


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
    # every bucket is frame-aligned and the presets' stem weights bf16: one
    # fused stem call a batch
    check(counts["wavlm_fused_stem"] == seen["batches"],
          f"{counts['wavlm_fused_stem']} fused stem calls for {seen['batches']} batches")
    # bf16 on the card, 128 taps, 64 channels a group: one positional conv call a batch
    check(counts["pos_conv_residual"] == seen["batches"],
          f"{counts['pos_conv_residual']} positional conv calls for {seen['batches']} batches")
    check(counts["flash_mha_bias"] == 0, "the pipeline took the long-bucket hatch (off by default)")
    # bf16 on the card: 50 norms a WavLM-Large batch
    check_layer_norms(phase, counts, cfg.num_hidden_layers, seen["batches"])
    # turbo: the six projections of each layer; turbo_ffn: the FFN's two
    int8 = INT8_GEMMS_A_LAYER["wavlm"].get(extractor.preset, 0) * cfg.num_hidden_layers \
        * seen["batches"]
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
        layer_norm_launches=counts["layer_norm"], layer_norm_fused=counts["layer_norm_fused"],
        wall_s=f"{wall:.2f}",
        store=f"3 splits x layers {','.join(map(str, layers))} x [n,{dim}]")

    check_resume(torch, pipe, extractor, meta, out, results)
    return dict(counts, batches=seen["batches"])


# the gated attention kernel's CUDA name in a profiler trace: the bf16 tile
# template (csrc/attention_tiles_sm90.cuh) with wavlm_attention.cu's policy
GATED_CUDA_NAME = ("attention_bf16_kernel", "GatedBiasRing")


def host_launch_us(torch, launches: int = 2000) -> float:
    """The host's median microseconds to enqueue one small kernel (five runs
    of ``launches`` in-place adds on a one-element tensor)."""
    x = torch.zeros(1, device="cuda")
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            x.add_(1)
        runs.append((time.perf_counter() - t0) / launches * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[2]


def phase_utils(torch, extractor, work: Path, card: str) -> dict:
    """utils/profiling.py on the card: one fast WavLM-Large batch of [slice]'s
    corpus through the extractor inside ``annotate("encode")`` under
    ``trace``; the Chrome trace holds the range and the gated kernel once a
    layer, under its CUDA name. A process's first trace may come back without
    the card's kernels, so the batch is traced twice and the second trace
    read. The host's time to enqueue a small kernel is taken before the first
    trace and after the second (whether a profiler session leaves cost behind
    in the process). Returns the launch counts of the traced batch."""
    import numpy as np

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.utils.profiling import annotate, trace

    meta = create_metadata_from_files(str(work / "corpus"))
    batcher = BucketBatcher(frame_align=extractor.frame_align)
    batch = next(iter(batcher.batches([r["path"] for r in meta], prefetch=False)))
    n_layers = extractor.cfg.num_hidden_layers
    on_card = extractor.device.type == "cuda"
    launch_us = [host_launch_us(torch)] if on_card else []
    for attempt in ("first", "second"):
        zero_counts()
        with trace(str(work / "utils_trace" / attempt)):
            with annotate("encode"):
                rows = extractor(batch)
            if on_card:
                torch.cuda.synchronize()
        counts = read_counts()
    launch_us += [host_launch_us(torch)] if on_card else []
    path, = (work / "utils_trace" / "second").glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e for e in events if e.get("name") == "encode"]
    gated = [e["name"] for e in events if e.get("cat") == "kernel"
             and all(part in e.get("name", "") for part in GATED_CUDA_NAME)]
    check(all(bool(np.isfinite(v).all()) for v in rows.values()), "utils: non-finite rows")
    check(len(ranges) >= 1, "utils: no 'encode' range in the trace")
    check(len(gated) == n_layers * on_card == counts["gated_relpos_attention"],
          f"utils: {len(gated)} gated kernels in the trace, {counts['gated_relpos_attention']} "
          f"counted, expected {n_layers * on_card}")
    say("utils", trace_events=len(events), encode_ranges=len(ranges),
        gated_kernels_in_trace=len(gated), launches=counts["gated_relpos_attention"],
        clips=len(batch.paths), batch=f"{len(batch.lengths)}x{batch.bucket_s:g}s", kernel=f'"{gated[0][:60] if gated else None}"',
        trace_mb=f"{path.stat().st_size / 1e6:.1f}",
        host_launch_us_before_after=",".join(f"{t:.2f}" for t in launch_us), card=f'"{card}"')
    return counts


# ---------------------------------------------------------------------------
# [decode]: the native host audio runtime (audio/csrc/wavio.cpp, ffdecode.cpp)
# ---------------------------------------------------------------------------

# every format of tests/test_audio_robustness.py's parametrisation: (format
# tag, bits, channels). The native parser is bit-equal to the numpy one on
# each: both round a stereo mean once (the f32 sum of two such samples is
# exact, or rounds as the double sum does before its halving).
DECODE_FORMATS = ((1, 8, 1), (1, 16, 2), (1, 24, 2), (1, 32, 1), (3, 32, 2), (3, 64, 1))
# the native resampler (windowed sinc, double sums) against the plain
# version's f32 conv1d: the JAX test's bar (tests/test_resample.py)
RESAMPLE_MAX_ABS = 1e-4
DECODE_RUNS = 5
# the chunk path's decode: one long 44.1 kHz file through load_audio
LONG_DECODE_S = 600.0
# [serve]'s 96-request burst on the numpy decoder (PR 11, H100 80GB HBM3, 700 W)
PR11_SERVE_P50_P95_MS = "616.6-710.8"


def wav_bytes(x, fmt_tag: int, bits: int, rate: int) -> bytes:
    """x [frames, channels] in [-1, 1] as a RIFF/WAVE file: integer PCM
    (fmt_tag 1) of 8, 16, 24 or 32 bits, or IEEE float (3) of 32 or 64."""
    import struct

    import numpy as np

    flat = x.reshape(-1)
    if fmt_tag == 3:
        payload = flat.astype(np.float32 if bits == 32 else np.float64).tobytes()
    elif bits == 8:
        payload = np.clip(np.round(flat * 128) + 128, 0, 255).astype(np.uint8).tobytes()
    else:
        scale = float(1 << (bits - 1))
        q = np.clip(np.round(flat * scale), -scale, scale - 1).astype("<i4")
        width = bits // 8  # little-endian: the low bytes of each int32
        payload = q.view(np.uint8).reshape(-1, 4)[:, :width].tobytes()
    channels = x.shape[1]
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", fmt_tag, channels, rate, rate * block, block, bits)
    body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def phase_decode(work: Path, card: str, clips: int = 128, seconds: float = 3.0) -> None:
    """The host audio runtime: its build (seconds, libav or not), the native
    parser bit-equal to the numpy one on every format, and ``decode_batch``
    (the C++ thread pool, 1 thread and the default) against
    ``decode_batch_plain`` (numpy, one file after another, torch resampling)
    on ``clips`` x ``seconds`` of 16-bit WAV at 16 kHz and at 44.1 kHz
    (resampled to 16 kHz): median ms per batch of DECODE_RUNS, in turns,
    after a warm call (the files then in the page cache); rows bit-equal at
    16 kHz, within RESAMPLE_MAX_ABS at 44.1 kHz. Then the chunk path's
    ``load_audio`` of one LONG_DECODE_S file at 44.1 kHz against its plain
    version, each of DECODE_RUNS calls."""
    import numpy as np

    from stutter_tpu_torch.audio import build as audio_build
    from stutter_tpu_torch.audio import wavio
    from stutter_tpu_torch.extract.batcher import BucketBatcher

    info = audio_build.build()
    threads = wavio.default_threads()
    say("decode_build", seconds=f"{info['seconds']:.2f}", libav=info["libav"],
        compressed='"libav"' if info["libav"] else '"no libav headers"',
        cpu_count=os.cpu_count(), default_threads=threads,
        library=info["wavio"].relative_to(ROOT), card=f'"{card}"')

    rng = np.random.RandomState(3)
    formats = work / "decode_formats"
    formats.mkdir()
    for tag, bits, channels in DECODE_FORMATS:
        path = formats / f"tag{tag}_{bits}bit_{channels}ch.wav"
        path.write_bytes(wav_bytes(np.clip(rng.randn(4000, channels) * 0.3, -0.99, 0.99),
                                   tag, bits, 16000))
        (x, sr), (y, sr_plain) = wavio.read_wav(str(path)), wavio.read_wav_plain(str(path))
        check(sr == sr_plain == 16000 and x.dtype == y.dtype == np.float32
              and np.array_equal(x, y), f"decode: native parser differs on {path.name}")
    say("decode_parse", formats=len(DECODE_FORMATS), native_vs_plain="bit-equal")

    max_samples = BucketBatcher(frame_align=(400, 320, 16)).bucket_samples(seconds)
    for rate in (16000, 44100):
        folder = work / f"decode_{rate}"
        folder.mkdir()
        paths, n = [], int(seconds * rate)
        for i in range(clips):
            t = np.arange(n) / rate
            x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 600) * t) + 0.05 * rng.randn(n)
            paths.append(str(folder / f"clip{i:03d}.wav"))
            wavio.write_wav(paths[-1], x, rate)
        fns = {"one": lambda: wavio.decode_batch(paths, 16000, max_samples, n_threads=1),
               "default": lambda: wavio.decode_batch(paths, 16000, max_samples, threads),
               "plain": lambda: wavio.decode_batch_plain(paths, 16000, max_samples)}
        outs = {k: fn() for k, fn in fns.items()}
        times = {k: [] for k in fns}
        for _ in range(DECODE_RUNS):
            for k, fn in fns.items():
                t0 = time.perf_counter()
                fn()
                times[k].append((time.perf_counter() - t0) * 1e3)
        ms = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        (w1, l1, ok1), (wn, ln, okn), (wp, lp, okp) = outs["one"], outs["default"], outs["plain"]
        check(ok1.all() and okn.all() and okp.all(), f"decode: a {rate} Hz clip failed")
        check(np.array_equal(w1, wn) and np.array_equal(l1, ln) and np.array_equal(l1, lp),
              f"decode: {rate} Hz rows or lengths differ between thread counts or the plain run")
        err = float(np.abs(wn - wp).max())
        check(err == 0.0 if rate == 16000 else err <= RESAMPLE_MAX_ABS,
              f"decode: {rate} Hz native rows {err:.3g} from the plain version's")
        say("decode", rate=rate, batch=f"{clips}x{seconds:g}s", samples=max_samples,
            ms_1_thread=f"{ms['one']:.1f}", threads=threads,
            ms_threads=f"{ms['default']:.1f}", plain_ms=f"{ms['plain']:.1f}",
            plain_over_threads=f"{ms['plain'] / ms['default']:.2f}",
            max_abs_vs_plain=f"{err:.3g}", tol=0.0 if rate == 16000 else RESAMPLE_MAX_ABS,
            runs=DECODE_RUNS, card=f'"{card}"')

    # the chunk path's decode: load_audio of one long file (the native
    # resampler on the default threads) against the plain version (the numpy
    # parser, then ops.resample in torch on the host)
    import torch

    from stutter_tpu_torch.ops.resample import resample

    long_path = str(work / "decode_long_44100.wav")
    wavio.write_wav(long_path, 0.1 * rng.randn(int(LONG_DECODE_S * 44100)), 44100)

    def load_plain():
        x, sr = wavio.read_wav_plain(long_path)
        return resample(torch.from_numpy(x), sr, 16000).numpy()

    fns = {"native": lambda: wavio.load_audio(long_path), "plain": load_plain}
    outs = {k: fn() for k, fn in fns.items()}
    times = {k: [] for k in fns}
    for _ in range(DECODE_RUNS):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[k].append((time.perf_counter() - t0) * 1e3)
    check(outs["native"] is not None and outs["native"].shape == outs["plain"].shape,
          "decode: load_audio failed on the long file or its length differs")
    err = float(np.abs(outs["native"] - outs["plain"]).max())
    check(err <= RESAMPLE_MAX_ABS, f"decode: load_audio {err:.3g} from the plain version's")
    say("decode_long", rate=44100, seconds=f"{LONG_DECODE_S:g}", threads=threads,
        torch_threads=torch.get_num_threads(),
        load_audio_ms=",".join(f"{t:.1f}" for t in times["native"]),
        plain_ms=",".join(f"{t:.1f}" for t in times["plain"]),
        max_abs_vs_plain=f"{err:.3g}", tol=RESAMPLE_MAX_ABS, card=f'"{card}"')


def phase_decode_flac(torch, extractor, work: Path, card: str) -> None:
    """With libav: [slice]'s corpus and its FLAC copy (``flac_copy``: each
    clip decodes to the WAV's samples) through ExtractionPipeline with one
    batcher's settings, so that both take the same batches: every store row
    bit-equal, the gated kernel launched once a layer a batch. Without libav
    the line says so and nothing is checked."""
    from stutter_tpu_torch.audio.build import get_ff_lib

    if get_ff_lib() is None:
        say("decode_flac", compressed='"no libav headers"', card=f'"{card}"')
        return
    import numpy as np

    from stutter_tpu_torch.audio.synthetic import flac_copy
    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    on_card = extractor.device.type == "cuda"
    n_layers = extractor.cfg.num_hidden_layers
    flac_copy(str(work / "corpus"), str(work / "flac_corpus"))
    runs = {}
    for name in ("corpus", "flac_corpus"):
        meta = create_metadata_from_files(str(work / name))
        pipe = ExtractionPipeline(extractor,
                                  batcher=BucketBatcher(frame_align=extractor.frame_align))
        seen = count_submits(extractor)
        zero_counts()
        pipe.run(meta, str(work / f"{name}_decode_store"))
        if on_card:
            torch.cuda.synchronize()
        counts = read_counts()
        del extractor.submit
        launches = counts["gated_relpos_attention"]
        check(launches == n_layers * seen["batches"] * on_card,
              f"decode_flac: {launches} gated launches for {seen['batches']} {name} batches")
        runs[name] = (len(meta), seen["batches"], launches)
    check(runs["corpus"] == runs["flac_corpus"], f"decode_flac: runs differ {runs}")
    rows = 0
    for split in ("train", "test", "devel"):
        for layer in extractor.layer_indices:
            f = f"{split}/layer_{layer}_embeddings.npy"
            a = np.load(work / "corpus_decode_store" / f)
            b = np.load(work / "flac_corpus_decode_store" / f)
            check(a.shape == b.shape and np.array_equal(a, b),
                  f"decode_flac: {f} differs between the WAV and the FLAC corpus")
        rows += len(a)
    clips, batches, launches = runs["flac_corpus"]
    say("decode_flac", clips=clips, rows=rows, batches=batches, launches=launches,
        expected=f"{n_layers}x{batches}", rows_vs_wav="bit-equal", card=f'"{card}"')


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
    from stutter_tpu_torch.utils.benchmarking import wavlm_flops

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
    B, T = batch.waves.shape
    enc_flops, stem_flops, _ = wavlm_flops(extractor.cfg, B, T)
    say_mfu("wavlm-large", extractor.preset, f"{B}x{T}", enc_flops + stem_flops, encode_ms, card)
    return audio_s / wall


def say_mfu(model: str, preset: str, batch: str, flops: int, device_ms: float,
            card: str) -> None:
    """A device-only encode's MFU: the FLOP model's count (utils/benchmarking.py)
    over the CUDA-event time, at the card's bf16 peak."""
    from stutter_tpu_torch.utils.benchmarking import BF16_PEAK

    rate = flops / (device_ms / 1e3)
    say("mfu", model=model, preset=preset, batch=batch, gflop=f"{flops / 1e9:.1f}",
        device_ms=f"{device_ms:.1f}", tflop_per_s=f"{rate / 1e12:.1f}",
        mfu=f"{rate / BF16_PEAK:.4f}", peak="bf16_989e12", card=f'"{card}"')


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
    Also the operations of a dense design, the 400 x 402 windowed DFT and
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


def logmel_edge_clips(torch, B: int, seed: int):
    """[B, 480000] f32 on the card for the untimed cases: one loud burst
    (peak ~4) in 1e-6 noise when B is 1; else ``whisper_test_clips`` with a
    pure 440 Hz tone (made in float64 and rounded once: f32 time stamps
    would add phase noise ~60 dB under it) and such a burst in clips 3 and
    4."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(480_000, device="cuda", dtype=torch.float64) / 16000.0

    def burst():
        clip = 1e-6 * torch.randn(480_000, device="cuda", generator=g)
        clip[96_000:112_000] = torch.randn(16_000, device="cuda", generator=g)
        return clip

    if B == 1:
        return burst()[None]
    wave = whisper_test_clips(torch, B, seed)
    wave[3] = (0.5 * torch.sin(2 * torch.pi * 440.0 * t)).float()
    wave[4] = burst()
    return wave


def phase_logmel(torch, logmel):
    """Log-mel kernel against its plain version and the float64 log-mel (the
    plain version on float64 tensors) at the path's 16 x 30 s, and untimed
    at 1 and 17 clips (a pure tone, a loud burst in 1e-6 noise, silent,
    quiet and zero-padded clips); returns (worst max-abs error from the
    plain version, the numbers at 80 mels)."""
    from stutter_tpu_torch.utils.benchmarking import F32_PEAK, bound

    worst, headline = 0.0, None
    for n_mels in (80, 128):
        for B in (16, 1, 17):
            wave = (whisper_test_clips(torch, 16, seed=n_mels) if B == 16
                    else logmel_edge_clips(torch, B, seed=B + n_mels))
            out = logmel.whisper_log_mel(wave, n_mels)
            ref = logmel.log_mel_spectrogram_reference(wave, n_mels)
            exact = logmel.log_mel_spectrogram_reference(wave.double(), n_mels)
            torch.cuda.synchronize()
            check(out.shape == ref.shape == (B, n_mels, 3000) and out.dtype == torch.float32,
                  f"log-mel kernel output {out.dtype} {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), "log-mel kernel output has non-finite values")
            max_abs = float((out - ref).abs().max())
            exact_abs = float((out.double() - exact).abs().max())
            plain_exact_abs = float((ref.double() - exact).abs().max())
            silent_ok = B == 1 or bool((out[0] == -1.5).all())  # log10(1e-10) floored, scaled
            fields = dict(shape=f"{B}x480000", n_mels=n_mels, max_abs_err=f"{max_abs:.3e}",
                          max_abs_err_vs_float64=f"{exact_abs:.3e}",
                          plain_vs_float64=f"{plain_exact_abs:.3e}",
                          max_abs_tol=LOGMEL_MAX_ABS, silent_clip_exact=silent_ok)
            if B == 16:
                ms, plain_ms = time_turns(
                    torch, lambda: logmel.whisper_log_mel(wave, n_mels),
                    lambda: logmel.log_mel_spectrogram_reference(wave, n_mels))
                queued_ms, = time_turns(torch, lambda: logmel.whisper_log_mel(wave, n_mels),
                                        reps=8)
                flops, nbytes, dense_flops = logmel_work(wave, out, n_mels)
                numbers = timing(ms, plain_ms, *bound(flops, nbytes, F32_PEAK))
                numbers["queued_ms"] = queued_ms
                # a dense design's bound (the windowed DFT as a product), for comparison
                dense_ms, _ = bound(dense_flops, nbytes, F32_PEAK)
                fields.update(shown(numbers), bound_dense_dft_ms=f"{dense_ms:.4f}")
                headline = headline or numbers
            say("logmel", **fields)
            check(max_abs <= LOGMEL_MAX_ABS and exact_abs <= LOGMEL_MAX_ABS and silent_ok,
                  f"log-mel kernel disagrees at {B} clips, {n_mels} mels")
            worst = max(worst, max_abs)
            del wave, out, ref, exact
    torch.cuda.empty_cache()
    return worst, headline


def error_map(out, ref) -> str:
    """Max-abs error of clip 0, head 0 by block of 16 rows and 8 columns."""
    err = (out[0, 0].float() - ref[0, 0].float()).abs()
    L = err.shape[0]
    lines = []
    for r0 in range(0, min(L, 128), 16):
        row = [float(err[r0:r0 + 16, c0:c0 + 8].max()) for c0 in range(0, 64, 8)]
        lines.append(f"    rows {r0:4d}+16: " + " ".join(f"{x:8.1e}" for x in row))
    return "\n".join(lines)


def phase_tile_edges(torch, mha) -> dict:
    """The bf16 wgmma tiles where they are most likely to be wrong: flash_mha
    at head_dim 64 and 120 (``flash_mha_hd120``: its zero-filled K panel and
    its two V panels) and flash_mha_bias, on structured inputs, at ragged
    lengths and key counts, ab through 16-byte and element-wise copies, a
    contiguous input, 70,000 blocks. A case that disagrees prints a map of
    its errors; returns each kernel's worst max-abs error."""
    g = torch.Generator(device="cuda").manual_seed(3)
    bf16 = torch.bfloat16
    cases, failures = 0, 0
    worst = {"flash_mha": 0.0, "flash_mha_bias": 0.0, "flash_mha_hd120": 0.0}

    def report(name, shape, extra, out, ref):
        nonlocal cases, failures
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all())
        laid_out = out.shape == ref.shape and out.dtype == ref.dtype
        max_abs = float((out.float() - ref.float()).abs().max())
        cos = cosine_distance(out.float(), ref.float())
        ok = finite and laid_out and max_abs <= BF16_MAX_ABS and cos <= BF16_COSINE
        cases += 1
        worst[name] = max(worst[name], max_abs)
        if not ok:
            failures += 1
            print(f"[check] {name} {shape} {extra} finite={finite} max_abs={max_abs:.3e} "
                  f"cosine={cos:.3e} DISAGREES", flush=True)
            print(error_map(out, ref), flush=True)

    # structured inputs first: they tell a wrong descriptor from a wrong softmax
    q, k, v = make_qkv(torch, g, 1, 1, 64, bf16)
    zero = torch.zeros_like(q)
    report("flash_mha", "1x1x64", "q=0 (out = mean of v)", mha.flash_mha(zero, k, v),
           mha.flash_mha_reference(zero, k, v))
    eye = torch.eye(64, device="cuda").bfloat16()[None, :, None, :].transpose(1, 2)
    report("flash_mha", "1x1x64", "v=I (out = probabilities)", mha.flash_mha(q * 4, k, eye),
           mha.flash_mha_reference(q * 4, k, eye))

    for L in (64, 65, 127, 128, 129, 37, 1008, 1500, 1504):
        B, H = (2, 3) if L > 200 else (3, 5)
        q, k, v = make_qkv(torch, g, B, H, L, bf16)
        report("flash_mha", f"{B}x{H}x{L}", "kv=all", mha.flash_mha(q, k, v),
               mha.flash_mha_reference(q, k, v))
        for valid in (0, 1, 63, 64, 65, L):
            kv = torch.tensor([min(valid, L), L, max(L - 1, 0)][:B], dtype=torch.int32,
                              device="cuda")
            report("flash_mha", f"{B}x{H}x{L}", f"kv={kv.tolist()}", mha.flash_mha(q, k, v, kv),
                   mha.flash_mha_reference(q, k, v, kv))
        ab = torch.randn(B, H, L, L, device="cuda", generator=g)
        ab[:, :, :, L - L // 3:] += -1e9  # keys masked, as WavLM's short clips mask them
        ab[0] = torch.randn(H, L, L, device="cuda", generator=g)
        report("flash_mha_bias", f"{B}x{H}x{L}", f"vec={mha.ab_vector_bytes(ab)}",
               mha.flash_mha_bias(q, k, v, ab), mha.flash_mha_bias_reference(q, k, v, ab))
        if L % 4 == 0:  # the same through the element-wise copies: ab off 16-byte alignment
            shifted = torch.empty(ab.numel() + 1, device="cuda")[1:].view_as(ab).copy_(ab)
            report("flash_mha_bias", f"{B}x{H}x{L}", f"vec={mha.ab_vector_bytes(shifted)}",
                   mha.flash_mha_bias(q, k, v, shifted),
                   mha.flash_mha_bias_reference(q, k, v, shifted))
    # head_dim 120: q = 0 and v = I over 120 keys (each output column one
    # key's probability, both V panels), then the ragged lengths and key counts
    q, k, _ = make_qkv(torch, g, 1, 1, 120, bf16, d=120)
    eye = torch.eye(120, device="cuda").bfloat16()[None, :, None, :].transpose(1, 2)
    report("flash_mha_hd120", "1x1x120", "q=0 (out = mean of v)",
           mha.flash_mha(torch.zeros_like(q), k, eye),
           mha.flash_mha_reference(torch.zeros_like(q), k, eye))
    report("flash_mha_hd120", "1x1x120", "v=I (out = probabilities)",
           mha.flash_mha(q * 4, k, eye), mha.flash_mha_reference(q * 4, k, eye))
    for L in (37, 64, 65, 127, 128, 129, 1008, 1504):
        B, H = (2, 3) if L > 200 else (3, 5)
        q, k, v = make_qkv(torch, g, B, H, L, bf16, d=120)
        report("flash_mha_hd120", f"{B}x{H}x{L}x120", "kv=all", mha.flash_mha(q, k, v),
               mha.flash_mha_reference(q, k, v))
        for valid in (0, 1, 63, 64, 65):
            kv = torch.tensor([min(valid, L), L, max(L - 1, 0)][:B], dtype=torch.int32,
                              device="cuda")
            report("flash_mha_hd120", f"{B}x{H}x{L}x120", f"kv={kv.tolist()}",
                   mha.flash_mha(q, k, v, kv), mha.flash_mha_reference(q, k, v, kv))
    q, k, v = make_qkv(torch, g, 2, 3, 129, bf16, transposed=False, d=120)
    report("flash_mha_hd120", "2x3x129x120", "contiguous", mha.flash_mha(q, k, v),
           mha.flash_mha_reference(q, k, v))
    # a contiguous [B, H, L, 64] input, and a grid of more than 65,535 blocks
    q, k, v = make_qkv(torch, g, 2, 3, 129, bf16, transposed=False)
    report("flash_mha", "2x3x129", "contiguous", mha.flash_mha(q, k, v),
           mha.flash_mha_reference(q, k, v))
    q, k, v = make_qkv(torch, g, 3500, 20, 64, bf16)
    report("flash_mha", "3500x20x64", "70000 blocks", mha.flash_mha(q, k, v),
           mha.flash_mha_reference(q, k, v))
    say("mha_edges", cases=cases, disagree=failures,
        **{f"{name}_worst_max_abs": f"{err:.3e}" for name, err in worst.items()},
        max_abs_tol=BF16_MAX_ABS, cosine_tol=BF16_COSINE)
    check(failures == 0, f"{failures} of {cases} bf16 tile edge cases disagree")
    return worst


# the bf16 wgmma tiles' instantiations: policy<head_dim, warpgroups, stages,
# blocks an SM, grid order (0 query tile fastest, 1 clip fastest)>
TILE_KERNELS = {"KeyPadding<64, 2, 4, 2, 0>", "KeyPadding<120, 2, 4, 1, 0>",
                "FullBias<64, 2, 4, 1, 0>", "GatedBiasRing<64, 1, 3, 2, 0>",
                "GatedBiasRing<64, 1, 3, 2, 1>", "RelKeyTable<64, 2, 4, 2, 0>"}
# the bf16 backward's wgmma kernels: dq and dk+dv in either grid order, dbias
BWD_TILE_KERNELS = {"dq<0>", "dq<1>", "dkv<0>", "dkv<1>", "dbias"}
# the stem's wgmma conv kernels, by taps
STEM_TILE_KERNELS = {"conv<3>", "conv<2>"}
# the positional conv's kernels, by channels a group (WavLM-Large's 64, XLS-R 2B's 120)
POS_CONV_KERNELS = {"pos_conv<64>", "pos_conv<120>"}
# the probes' kernels: the int8 prologue and main kernel, the four variants
PROBE_KERNELS = {"quantize_kv", "attn_int8", "softmax_variant<0, 0>", "softmax_variant<1, 0>",
                 "softmax_variant<0, 1>", "softmax_variant<1, 1>"}


def phase_gated_edges(torch, attn) -> float:
    """The gated attention's bf16 wgmma tiles where they are most likely to
    be wrong, in both grid orders, output and row statistics: ragged lengths
    around the 64- and 128-row edges and the 20 s bucket, where clip 0 has
    every key, clip 1 half of them, clip 2 none, clip 3 every key and a gate
    of 0; the bias through its 16-byte copies and, off 16-byte alignment,
    its element-wise ones; a contiguous input. Returns the worst max-abs
    error of the output."""
    from stutter_tpu_torch.ops._attention import vector_bytes

    g = torch.Generator(device="cuda").manual_seed(4)
    cases, failures, worst, worst_stats = 0, 0, 0.0, 0.0

    def run(L, args, what, order):
        nonlocal cases, failures, worst, worst_stats
        B, H = args[0].shape[:2]
        stats = torch.empty(2, B, H, L, device="cuda")
        out = attn.launch_tiles(*args, stats, order)
        ref = attn.gated_relpos_attention_reference(*args)
        ref_stats = attn.attention_row_stats_reference(*args[:2], *args[3:])
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all())
        max_abs = float((out.float() - ref.float()).abs().max())
        cos = cosine_distance(out.float(), ref.float())
        stats_err = float((stats - ref_stats).abs().max())
        ok = (finite and out.stride() == args[0].stride() and max_abs <= BF16_MAX_ABS
              and cos <= BF16_COSINE and stats_err <= BWD_STATS_MAX_ABS)
        cases += 1
        worst, worst_stats = max(worst, max_abs), max(worst_stats, stats_err)
        if not ok:
            failures += 1
            print(f"[check] gated {B}x{H}x{L} {what} order={order} "
                  f"vec={vector_bytes(args[3], args[5])} finite={finite} "
                  f"max_abs={max_abs:.3e} cosine={cos:.3e} stats_max_abs={stats_err:.3e} "
                  f"DISAGREES", flush=True)
            print(error_map(out, ref), flush=True)

    for L in (37, 63, 64, 65, 127, 128, 129, 160, 1008):
        B, H = 4, (3 if L > 200 else 5)
        lengths = torch.tensor([L, max(L // 2, 1), 0, L], device="cuda")
        args = attention_inputs(torch, g, B, H, L, torch.bfloat16, lengths)
        args[4][3] = 0.0
        for order in (attn.QUERY_TILE_FASTEST, attn.CLIP_FASTEST):
            run(L, args, "", order)
        if L % 4 == 0:  # the bias off 16-byte alignment: element-wise copies
            bias = args[3]
            shifted = torch.empty(bias.numel() + 1, device="cuda")[1:].view_as(bias).copy_(bias)
            run(L, (*args[:3], shifted, *args[4:]), "bias+4B", attn.CLIP_FASTEST)
    lengths = torch.tensor([129, 100, 0], device="cuda")
    args = attention_inputs(torch, g, 3, 4, 129, torch.bfloat16, lengths, transposed=False)
    run(129, args, "contiguous", attn.QUERY_TILE_FASTEST)
    say("gated_edges", cases=cases, disagree=failures, worst_max_abs=f"{worst:.3e}",
        worst_stats_max_abs=f"{worst_stats:.3e}", max_abs_tol=BF16_MAX_ABS,
        cosine_tol=BF16_COSINE, stats_tol=BWD_STATS_MAX_ABS)
    check(failures == 0, f"{failures} of {cases} gated tile edge cases disagree")
    return worst


def bwd_inputs(torch, g, B, H, L, lengths, transposed=True, zero_gate_clip=None):
    """The backward's operands: ``attention_inputs`` in bf16 (clip
    ``zero_gate_clip``'s gate 0), the forward's output and row statistics,
    and a do laid out like q."""
    from stutter_tpu_torch.ops import wavlm_attention as attn

    args = attention_inputs(torch, g, B, H, L, torch.bfloat16, lengths, transposed)
    if zero_gate_clip is not None:
        args[4][zero_gate_clip] = 0.0
    stats = torch.empty(2, B, H, L, device="cuda")
    out = attn.gated_relpos_attention(*args, stats)
    do = make_qkv(torch, g, B, H, L, torch.bfloat16, transposed)[0]
    return args, out, do, stats


def compare_grads(torch, got, ref) -> tuple[bool, dict]:
    """Each gradient against the plain backward's: finite, shaped and typed
    alike, max-abs error over the plain result's max and cosine distance
    within the bf16 bars. Returns (all agree, {name: (rel, cosine)})."""
    ok, errs = True, {}
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dgate"), got, ref):
        same = a.shape == b.shape and a.dtype == b.dtype and bool(torch.isfinite(a).all())
        rel = float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
        cos = cosine_distance(a.float(), b.float())
        errs[name] = (rel, cos)
        ok = ok and same and rel <= BWD_BF16_REL and cos <= BWD_BF16_COSINE
    return ok, errs


# the backward's edge lengths: around the tiles' 64-row edges, then 512 and 1008
BWD_EDGE_LENGTHS = (37, 63, 64, 65, 127, 128, 129, 160, 512, 1008)


def phase_bwd_edges(torch, attn) -> float:
    """The bf16 backward where its tiles are most likely to be wrong, against
    the plain backward at ``BWD_EDGE_LENGTHS``: clip 0 has every key, clip 1
    half of them, clip 2 none, clip 3 every key and a gate of 0; the dq and
    dk+dv kernels in both grid orders; the dbias kernel with one group of
    clips and with two (partial planes added by a second kernel); the f32
    planes through their 16-byte and, with the bias off 16-byte alignment,
    their element-wise copies; a contiguous input. Returns the worst max-abs
    error over the plain result's max."""
    from stutter_tpu_torch.ops._attention import vector_bytes

    g = torch.Generator(device="cuda").manual_seed(8)
    cases, failures, worst = 0, 0, 0.0

    def run(L, args, out, do, stats, what, order, groups):
        nonlocal cases, failures, worst
        got = attn.launch_backward(*args, out, do, stats, order, groups)
        ref = attn.gated_relpos_attention_backward_reference(*args, out, do)
        torch.cuda.synchronize()
        ok, errs = compare_grads(torch, got, ref)
        ok = ok and all(t.stride() == args[0].stride() for t in got[:3])
        cases += 1
        worst = max([worst] + [rel for rel, _ in errs.values()])
        if not ok:
            failures += 1
            B, H = args[0].shape[:2]
            print(f"[check] bwd {B}x{H}x{L} {what} order={order} groups={groups} "
                  f"vec={vector_bytes(args[3], args[5])} "
                  + " ".join(f"{n}={r:.2e}/{c:.2e}" for n, (r, c) in errs.items())
                  + " DISAGREES", flush=True)

    for L in BWD_EDGE_LENGTHS:
        B, H = 4, (2 if L > 200 else 3)
        lengths = torch.tensor([L, max(L // 2, 1), 0, L], device="cuda")
        args, out, do, stats = bwd_inputs(torch, g, B, H, L, lengths, zero_gate_clip=3)
        for order in (attn.QUERY_TILE_FASTEST, attn.CLIP_FASTEST):
            run(L, args, out, do, stats, "", order, 1)
        run(L, args, out, do, stats, "", attn.grid_order_for(H, L), 2)
        if L % 4 == 0:  # the bias off 16-byte alignment: element-wise copies
            bias = args[3]
            shifted = torch.empty(bias.numel() + 1, device="cuda")[1:].view_as(bias).copy_(bias)
            run(L, (*args[:3], shifted, *args[4:]), out, do, stats, "bias+4B",
                attn.CLIP_FASTEST, 2)
    lengths = torch.tensor([129, 100, 0], device="cuda")
    args, out, do, stats = bwd_inputs(torch, g, 3, 4, 129, lengths, transposed=False)
    run(129, args, out, do, stats, "contiguous", attn.QUERY_TILE_FASTEST, 3)
    say("bwd_edges", cases=cases, disagree=failures, worst_rel=f"{worst:.3e}",
        rel_tol=BWD_BF16_REL, cosine_tol=BWD_BF16_COSINE)
    check(failures == 0, f"{failures} of {cases} backward edge cases disagree")
    return worst


def tile_kernels(build) -> list[dict]:
    """ptxas's rows for the bf16 tiles' kernels, each named by its policy and
    its <head_dim, warpgroups, stages, blocks an SM, grid order>."""
    import re

    rows = build.resource_report("4sm9021attention_bf16_kernel")
    for row in rows:
        m = re.search(r"(\w+?)((?:ELi\d+){5})E", row["kernel"])
        scope, ints = m.group(1), re.findall(r"[0-9]+", m.group(2))
        scope = re.sub(r"I\d\w*E$", "", scope)  # a policy's own template arguments
        # the policy is the last <length><name> of its mangled scope
        policy = next(n.group(2) for i in range(len(scope) - 1, -1, -1)
                      if (n := re.fullmatch(r"([0-9]+)([A-Za-z_]\w*)", scope[i:]))
                      and int(n.group(1)) == len(n.group(2)))
        row["tiles"] = f"{policy}<{', '.join(ints)}>"
    return rows


def kernel_rows(build, kernel: str, pattern: str, name) -> list[dict]:
    """ptxas's rows for the kernels whose mangled names contain ``kernel``
    and match the regular expression ``pattern``, each named ``name(match)``
    under ``tiles``."""
    import re

    return [dict(row, tiles=name(m)) for row in build.resource_report(kernel)
            if (m := re.search(pattern, row["kernel"]))]


def sass_functions(lib_path: Path) -> dict[str, list[tuple[int, str]]]:
    """The SASS of every kernel of a built library (``cuobjdump -sass``):
    {mangled name: [(address, instruction text)]}, branch targets written as
    addresses."""
    import re

    from stutter_tpu_torch.ops._build import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, labels, pending = m.group(1), {}, []
            funcs[name] = []
            continue
        if name is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            funcs[name].append((addr, m.group(2)))
    for name, instrs in funcs.items():  # labels -> addresses
        funcs[name] = [(a, re.sub(r"`?\(?(\.L_x_\d+)\)?", lambda m: hex(labels.get(m.group(1), -1)),
                                  s)) for a, s in instrs]
    return funcs


def opcode(text: str) -> str:
    """An instruction's opcode without its predicate: MUFU keeps its
    function (MUFU.EX2), the others lose their modifiers."""
    op = text.split()[1] if text.startswith("@") else text.split()[0]
    return op if op.startswith("MUFU") else op.split(".")[0]


def sass_loops(instrs: list[tuple[int, str]]) -> list[dict]:
    """The loops of one kernel that issue wgmma, in program order, with the
    opcodes their body always runs: the instructions between a loop's head
    and its backward branch that no forward branch inside the body jumps
    over (the edge tile's masking, a rescale, the 4-byte copies are skipped
    on the common path). ``tiles``: key tiles an iteration (MUFU.EX2 / 32,
    one exponential a score and 32 scores a thread and tile)."""
    import re

    index = {a: i for i, (a, _) in enumerate(instrs)}
    branches = []
    for i, (a, text) in enumerate(instrs):
        m = re.search(r"\bBRA\S*\s+(?:[^,;]*,\s*)?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) in index:
            branches.append((i, index[int(m.group(1), 16)]))
    loops = []
    last = {}  # a loop's head -> its last backward branch
    for i, head in branches:
        if head < i:
            last[head] = max(i, last.get(head, i))
    for head, i in last.items():
        body = range(head, i + 1)
        if not any("GMMA" in opcode(instrs[j][1]) for j in body):
            continue
        skipped = set()
        for a, target in branches:
            if head <= a < target <= i:
                skipped.update(range(a + 1, target))
        counts = {}
        for j in body:
            if j not in skipped:
                op = opcode(instrs[j][1])
                counts[op] = counts.get(op, 0) + 1
        loops.append({"head": instrs[head][0], "counts": counts,
                      "tiles": max(1, round(counts.get("MUFU.EX2", 0) / 32))})
    return sorted(loops, key=lambda loop: loop["head"])


# the opcodes of a score's chain, shown per score
CHAIN_OPS = ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "MUFU.EX2", "F2FP", "HFMA2", "HADD2",
             "HMUL2", "HMNMX2", "PRMT", "IADD3", "LOP3", "I2F", "F2I", "LDS", "SHFL")


def probe_sass(lib_path: Path) -> list[dict]:
    """Per probe kernel: its wgmma and mma.sync opcodes, and per wgmma loop
    (a pass) the chain's opcodes per score and all instructions per score."""
    import re

    rows = []
    for name, instrs in sass_functions(lib_path).items():
        m = re.search(r"softmax_variant_kernelILb(\d)ELb(\d)EE", name)
        kernel = (f"softmax_variant<{m.group(1)}, {m.group(2)}>" if m else
                  "attn_int8" if "attn_int8_kernel" in name else None)
        if kernel is None:
            continue
        ops = [opcode(text) for _, text in instrs]
        row = {"kernel": kernel, **{op: ops.count(op) for op in ("HGMMA", "IGMMA", "HMMA", "IMMA")},
               "passes": []}
        for loop in sass_loops(instrs):
            per = 32 * loop["tiles"]
            row["passes"].append({
                "tiles_an_iteration": loop["tiles"],
                "per_score": {op: round(loop["counts"].get(op, 0) / per, 3) for op in CHAIN_OPS
                              if loop["counts"].get(op)},
                "all_per_score": round(sum(loop["counts"].values()) / per, 3)})
        rows.append(row)
    return sorted(rows, key=lambda row: row["kernel"])


def phase_tile_resources(build) -> None:
    """What ptxas said of the bf16 wgmma kernels at the build, every
    instantiation of the forward tiles, of the backward, of the stem's conv
    layers, of the positional conv and of the probes: no spill, no stack, no
    serialised wgmma; and, from the SASS, that the probes' main kernels issue
    wgmma and no mma.sync."""
    # (how its [ptxas] lines name a kernel, its rows, the instantiations expected)
    families = [
        ("attention_bf16_kernel<{}>", tile_kernels(build), TILE_KERNELS),
        ("bwd_{}", kernel_rows(build, "_bf16_kernel",
                               r"bwd_(dq|dkv|dbias)_bf16_kernel(?:ILi(\d+)EE)?",
                               lambda m: m[1] + (f"<{m[2]}>" if m[2] else "")), BWD_TILE_KERNELS),
        ("stem_{}", kernel_rows(build, "stem_conv_kernel", r"stem_conv_kernelILi(\d+)EE",
                                lambda m: f"conv<{m[1]}>"), STEM_TILE_KERNELS),
        ("{}", kernel_rows(build, "pos_conv_kernel", r"pos_conv_kernelILi(\d+)EE",
                           lambda m: f"pos_conv<{m[1]}>"), POS_CONV_KERNELS),
        ("probe_{}", kernel_rows(
            build, "_kernel",
            r"(quantize_kv|attn_int8)_kernel|softmax_variant_kernelILb(\d)ELb(\d)EE",
            lambda m: m[1] or f"softmax_variant<{m[2]}, {m[3]}>"), PROBE_KERNELS)]
    for label, rows, expected in families:
        found = sorted(row["tiles"] for row in rows)
        check(found == sorted(expected), f"expected the kernels {sorted(expected)}, found {found}")
        for row in rows:
            name = label.format(row["tiles"])
            say("ptxas", kernel=name,
                registers=row["registers"], stack_bytes=row["stack_bytes"],
                spill_store_bytes=row["spill_store_bytes"],
                spill_load_bytes=row["spill_load_bytes"])
            check(row["stack_bytes"] == 0 and row["spill_store_bytes"] == 0
                  and row["spill_load_bytes"] == 0, f"{name}: the bf16 tiles spill")
    warnings = build.serialized_wgmma_warnings()
    say("ptxas", serialized_wgmma_warnings=len(warnings))
    check(not warnings, "ptxas serialised a wgmma:\n" + "\n".join(warnings))
    # the probes' main kernels issue wgmma (HGMMA, IGMMA) and no mma.sync
    for row in probe_sass(build.library_path()):
        gmma = row["IGMMA"] if row["kernel"] == "attn_int8" else row["HGMMA"]
        say("sass", kernel=row["kernel"], HGMMA=row["HGMMA"], IGMMA=row["IGMMA"],
            HMMA=row["HMMA"], IMMA=row["IMMA"],
            passes=";".join(f"{p['all_per_score']}/score" for p in row["passes"]))
        check(gmma > 0 and row["HMMA"] == 0 and row["IMMA"] == 0,
              f"probe {row['kernel']}: wgmma {gmma}, mma.sync {row['HMMA'] + row['IMMA']}")


def mha_cases(torch, mha, cases, head_dim: int, phase: str):
    """``flash_mha`` against its plain version on each case (B, H, L, dtype,
    key counts or None) of [B, L, H, head_dim] views, as the models pass
    them, timed in turns with the plain version and
    ``scaled_dot_product_attention`` (per launch, and 8 queued); returns
    (worst max-abs error, [(shape, dtype, key counts, numbers)])."""
    import torch.nn.functional as F

    from stutter_tpu_torch.utils.benchmarking import bound

    g = torch.Generator(device="cuda").manual_seed(0 if head_dim == 64 else 21)
    worst, rows = 0.0, []
    for B, H, L, dtype, kv in cases:
        q, k, v = make_qkv(torch, g, B, H, L, dtype, d=head_dim)
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
        ms, plain_ms, masked_ms, maskless_ms = time_turns(
            torch, lambda: mha.flash_mha(q, k, v, kv_valid),
            lambda: mha.flash_mha_reference(q, k, v, kv_valid),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask, scale=1.0),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
        # with every key valid the call without a mask is the same function, and
        # the library then picks a faster kernel: the yardstick is the faster one
        library_ms = masked_ms if kv is not None else min(masked_ms, maskless_ms)
        # the same with 8 launches enqueued back to back: the device's time alone
        queued_ms, queued_masked_ms, queued_maskless_ms = time_turns(
            torch, lambda: mha.flash_mha(q, k, v, kv_valid),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask, scale=1.0),
            lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), reps=8)
        queued_library_ms = (queued_masked_ms if kv is not None
                             else min(queued_masked_ms, queued_maskless_ms))
        n = B * H * L * head_dim  # q k^T and p v; q, k, v and out once each
        numbers = timing(ms, plain_ms, *bound(4 * n * L, 4 * n * q.element_size(),
                                              peak_flops(torch, dtype)), library_ms)
        say(phase, shape=f"{B}x{H}x{L}x{head_dim}", dtype=str(dtype).split(".")[-1],
            kv_valid=",".join(map(str, kv)) if kv else "all", max_abs_err=f"{max_abs:.3e}",
            max_abs_tol=tol_abs, cosine_dist=f"{cos:.3e}", cosine_tol=tol_cos,
            **shown(numbers), library_masked_ms=f"{masked_ms:.4f}",
            library_maskless_ms=f"{maskless_ms:.4f}" if kv is None else None,
            queued_ms=f"{queued_ms:.4f}", queued_library_ms=f"{queued_library_ms:.4f}",
            queued_tflops=f"{4 * n * L / queued_ms / 1e9:.1f}",
            roofline=f"{100 * numbers['bound_ms'] / queued_ms:.1f}%")
        check(max_abs <= tol_abs and cos <= tol_cos,
              f"flash_mha disagrees with its plain version at {B}x{H}x{L}x{head_dim} {dtype} "
              f"kv={kv}")
        worst = max(worst, max_abs)
        rows.append((f"{B}x{H}x{L}x{head_dim}", dtype, kv, dict(
            numbers, queued_ms=queued_ms, queued_library_ms=queued_library_ms)))
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    return worst, rows


def phase_mha(torch, mha):
    """Flash-attention kernel against its plain version, and the time of
    ``scaled_dot_product_attention`` on the same inputs; returns (worst
    max-abs error, the numbers at the bf16 encoder shape)."""
    worst, rows = mha_cases(torch, mha, [
        (16, 20, 1500, torch.bfloat16, None),   # Whisper-large encoder, fast preset
        (16, 20, 1500, torch.float32, None),    # fidelity preset
        (3, 20, 1500, torch.bfloat16, (1500, 700, 0)),
        (3, 20, 1500, torch.float32, (1500, 700, 0)),
        (5, 20, 37, torch.bfloat16, None),      # ragged L, one partial tile
        (5, 20, 37, torch.float32, None),
    ], 64, "mha")
    return worst, rows[0][3]


def phase_flash_mha_hd120(torch, mha):
    """The flash kernel at head_dim 120 (wav2vec2 XLS-R 2B's 16 heads of
    120) at the 30 s and 20 s buckets' batches, bf16 and f32, every key valid
    and with padded clips (``mha_cases``), and only the 120-wide instance
    launched; returns (worst max-abs error, the numbers of each bf16 case)."""
    before = dict(mha.flash_mha.launches_by_head_dim)
    worst, rows = mha_cases(torch, mha, [
        (8, 16, 1504, torch.bfloat16, None),    # 30 s bucket, fast preset
        (12, 16, 1008, torch.bfloat16, None),   # 20 s bucket
        (8, 16, 1504, torch.float32, None),     # fidelity preset
        (12, 16, 1008, torch.float32, None),
        (3, 16, 1504, torch.bfloat16, (1504, 700, 0)),
        (3, 16, 1504, torch.float32, (1504, 700, 0)),
    ], 120, "flash_mha_hd120")
    counted = {d: n - before.get(d, 0) for d, n in mha.flash_mha.launches_by_head_dim.items()}
    say("flash_mha_hd120", launches_by_head_dim=counted)
    check(counted.get(120, 0) > 0 and counted.get(64, 0) == 0,
          f"the 120-wide calls were counted as {counted}")
    return worst, {shape + ("" if kv is None else "_padded"): numbers
                   for shape, dtype, kv, numbers in rows if dtype == torch.bfloat16}


RELKEY_EDGE_LENGTHS = (37, 64, 65, 127, 128, 129, 999, 1499)


def relkey_inputs(torch, g, B, H, L, dtype, lengths):
    """q, k, v of ``make_qkv``, the [73, 64] distance embeddings (randn * 0.5,
    at k's scale, as the benchmark draws them) and the [B] int32 key counts."""
    q, k, v = make_qkv(torch, g, B, H, L, dtype)
    emb = (torch.randn(73, 64, device="cuda", generator=g) * 0.5).to(dtype)
    return q, k, v, emb, lengths.to(torch.int32).contiguous()


def relkey_bias(torch, rk, q, emb, kv_valid):
    """The [B, H, L, L] f32 additive bias the library call is given: the
    gathered relative-key terms and the key mask."""
    L = q.shape[2]
    table = torch.matmul(q.float(), emb.float().t())
    bias = torch.gather(table, -1, rk.relative_terms(L, q.device).expand(*q.shape[:2], L, L))
    keys = torch.arange(L, device=q.device)
    return bias.add_(torch.where(keys[None, :] < kv_valid[:, None], 0.0, -1e9)[:, None, None])


def phase_relkey_attn(torch, rk):
    """The relative-key attention kernel (w2v-BERT) against its plain version:
    at the 30 s bucket's 8 x 16 x 1499 x 64 and the 20 s bucket's
    12 x 16 x 999 x 64 (the benchmark's rows), and at 1504 and
    1008 with keys masked, in bf16, timed per launch and 8 queued beside
    the plain version and scaled_dot_product_attention given the
    materialised bias; f32 (the fidelity preset) at the 20 s bucket; then,
    checked and not timed, bf16 at ragged lengths around the 64-row tiles
    with key counts of 1, 63, 64, 65 and L. Returns (worst max-abs error,
    the numbers of each timed case)."""
    import torch.nn.functional as F

    from stutter_tpu_torch.utils.benchmarking import bound

    g = torch.Generator(device="cuda").manual_seed(25)
    worst, numbers_by_case = 0.0, {}
    timed_cases = [(8, 16, 1499, torch.bfloat16, False), (12, 16, 999, torch.bfloat16, True),
                   (8, 16, 1504, torch.bfloat16, False), (12, 16, 1008, torch.bfloat16, True),
                   (12, 16, 999, torch.float32, True)]
    edge_cases = [(5, 4, L, torch.bfloat16, True) for L in RELKEY_EDGE_LENGTHS]
    before = rk.relkey_attention.launches
    for B, H, L, dtype, padded in timed_cases + edge_cases:
        lengths = torch.full((B,), L, device="cuda")
        if padded:
            lengths = torch.randint(L // 3, L + 1, (B,), device="cuda", generator=g)
            lengths[0] = L
            if B == 5:  # the edge cases: key counts around a tile
                lengths = torch.tensor([L, 1, min(63, L), min(64, L), min(65, L)], device="cuda")
        q, k, v, emb, kv = relkey_inputs(torch, g, B, H, L, dtype, lengths)
        out = rk.relkey_attention(q, k, v, emb, kv)
        ref = rk.relkey_attention_reference(q, k, v, emb, kv)
        torch.cuda.synchronize()
        check(out.shape == ref.shape and out.dtype == dtype and out.stride() == q.stride(),
              f"relkey_attention output {out.dtype} {tuple(out.shape)} {out.stride()}")
        check(bool(torch.isfinite(out).all()), "relkey_attention output has non-finite values")
        max_abs = float((out.float() - ref.float()).abs().max())
        cos = cosine_distance(out.float(), ref.float())
        tol_abs, tol_cos = ((BF16_MAX_ABS, BF16_COSINE) if dtype == torch.bfloat16
                            else (F32_MAX_ABS, F32_COSINE))
        shape = f"{B}x{H}x{L}x64"
        fields = {}
        if (B, H, L, dtype, padded) in timed_cases:
            bias_q = relkey_bias(torch, rk, q, emb, kv).to(dtype)
            ms, plain_ms, library_ms = time_turns(
                torch, lambda: rk.relkey_attention(q, k, v, emb, kv),
                lambda: rk.relkey_attention_reference(q, k, v, emb, kv),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias_q, scale=1.0))
            queued_ms, queued_library_ms = time_turns(
                torch, lambda: rk.relkey_attention(q, k, v, emb, kv),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias_q, scale=1.0),
                reps=8)
            emb80 = F.pad(emb, (0, 0, 0, rk.TABLE_PITCH - rk.TERMS))
            table_ms, = time_turns(torch, lambda: torch.matmul(q.transpose(1, 2), emb80.t()),
                                   reps=8)
            del bias_q
            n = B * H * L * 64  # q k^T, p v and q E^T; q, k, v, out, E and kv once each
            numbers = timing(ms, plain_ms, *bound(
                4 * n * L + 2 * n * 73, 4 * n * q.element_size() + 73 * 64 * q.element_size()
                + 4 * B, peak_flops(torch, dtype)), library_ms)
            numbers_by_case[shape + ("_padded" if padded else "") + (
                "" if dtype == torch.bfloat16 else "_f32")] = dict(
                numbers, queued_ms=queued_ms, queued_library_ms=queued_library_ms,
                table_queued_ms=table_ms)
            fields = dict(shown(numbers), queued_ms=f"{queued_ms:.4f}",
                          queued_library_ms=f"{queued_library_ms:.4f}",
                          table_queued_ms=f"{table_ms:.4f}",
                          queued_share=f"{100 * numbers['bound_ms'] / queued_ms:.1f}")
        say("relkey_attn", shape=shape, dtype=str(dtype).split(".")[-1],
            keys=",".join(map(str, lengths.tolist()[:5])), max_abs_err=f"{max_abs:.3e}",
            max_abs_tol=tol_abs, cosine_dist=f"{cos:.3e}", cosine_tol=tol_cos, **fields)
        check(max_abs <= tol_abs and cos <= tol_cos,
              f"relkey_attention disagrees with its plain version at {shape} {dtype}")
        worst = max(worst, max_abs)
        del q, k, v, out, ref
        torch.cuda.empty_cache()
    check(rk.relkey_attention.launches > before, "relkey_attention.launches did not count")
    return worst, numbers_by_case


def seeded_w2v_bert(torch, cfg, device: str = "cuda"):
    """A float32 ``W2VBertModel`` on ``device``, loaded with the benchmark's
    kind of draw: dense and conv weights normal * fan_in^-1/2, norm scales
    1 + 0.1 n, other vectors 0.02 n, the distance embeddings at k's scale."""
    import math

    from stutter_tpu_torch.models.w2v_bert import W2VBertModel

    model = W2VBertModel(cfg, device=device)
    g = torch.Generator(device=device).manual_seed(25)
    state = {}
    for name, p in model.state_dict().items():
        std, mean = 0.02, 0.0
        if name.endswith("distance_embedding"):
            std = 1.0
        elif p.dim() >= 2:
            std = math.prod(p.shape[1:]) ** -0.5
        elif name.endswith(("_s", "ln_scale")):
            std, mean = 0.1, 1.0
        state[name] = torch.randn(p.shape, device=device, generator=g) * std + mean
    model.load_state_dict(state)
    return model


def phase_w2v_bert_slice(torch, rk, cfg=None, device: str = "cuda") -> dict:
    """w2v-BERT 2.0 at its published widths through ``W2VBertExtractor``
    (fast), one batch of each bucket the benchmark's cell fills: 12 x 20 s
    (999 rows) and 8 x 30 s (1499 rows), ragged clips. Per batch: one
    relative-key launch a layer and six norms (four with the residual add
    fused; the 160-wide projection norm is plain), and no other kernel; the
    pooled rows against the same batch with both gates closed (the plain
    norms and the plain relative-key attention, bf16). Returns the launch
    counts of both batches. (``cfg`` and ``device`` are for a dry run on
    the CPU: a smaller model, and no kernel counted.)"""
    import numpy as np

    import stutter_tpu_torch.models.w2v_bert as w2v_bert
    from stutter_tpu_torch.extract.batcher import Batch
    from stutter_tpu_torch.extract.pipeline import W2VBertExtractor
    from stutter_tpu_torch.models.w2v_bert import W2VBertConfig
    from stutter_tpu_torch.ops import layer_norm as ln

    cfg = cfg or W2VBertConfig.w2v_bert_2_0()
    ex = W2VBertExtractor(seeded_w2v_bert(torch, cfg, device), device, preset="fast")
    n = cfg.num_hidden_layers * (device == "cuda")
    want = {"relkey_attention": n, "layer_norm": 6 * n, "layer_norm_fused": 4 * n}
    totals = dict.fromkeys(want, 0)
    rng = np.random.default_rng(25)
    for B, seconds in ((12, 20), (8, 30)):
        T = seconds * 16000
        lengths = rng.integers(T * 3 // 4, T + 1, B)
        lengths[0] = T
        waves = np.zeros((B, T), np.float32)
        for i, m in enumerate(lengths):
            waves[i, :m] = 0.1 * rng.standard_normal(m)
        batch = Batch(paths=[f"w2v_bert_{i}" for i in range(B)], rows=list(range(B)),
                      waves=waves, lengths=lengths, ok=np.ones(B, bool), bucket_s=seconds)
        zero_counts()
        got = ex(batch)
        counts = read_counts()
        shape = f"{B}x{ex.frame_count(T)}"
        check({k: counts[k] for k in want} == want,
              f"w2v_bert_slice {shape}: launches {counts}, expected {want}")
        check(not any(v for k, v in counts.items() if k not in want),
              f"w2v_bert_slice {shape}: other kernels launched: {counts}")
        for k in want:
            totals[k] += counts[k]
        real = ln._on_card, w2v_bert.relkey_self_attention
        ln._on_card = lambda t: False
        w2v_bert.relkey_self_attention = rk.relkey_attention_reference
        try:
            plain = ex(batch)
        finally:
            ln._on_card, w2v_bert.relkey_self_attention = real
        check(read_counts() == counts, "w2v_bert_slice: the closed gates launched a kernel")
        worst = max(cosine_distance(*map(torch.from_numpy, (got[c][i], plain[c][i])))
                    for c in got for i in range(B))
        say("w2v_bert_slice", batch=shape, relkey_launches=counts["relkey_attention"],
            layer_norm_launches=counts["layer_norm"], fused=counts["layer_norm_fused"],
            expected=",".join(map(str, want.values())),
            pooled_cosine_vs_gates_closed=f"{worst:.3e}", tol=FAST_POOLED_COSINE)
        check(worst <= FAST_POOLED_COSINE,
              f"w2v_bert_slice {shape}: pooled rows {worst:.3e} from the gates-closed batch")
    del ex
    if device == "cuda":
        torch.cuda.empty_cache()
    return totals


def phase_mha_bias(torch, mha):
    """The materialised-bias flash kernel against its plain version at the
    hatch's 30 s and 20 s buckets (bf16, keys masked for short clips) and
    at a ragged f32 length, with ``scaled_dot_product_attention`` given the
    same ab as its mask (cast to q's dtype, as the call requires); returns
    (worst max-abs error, the numbers at the 30 s bucket)."""
    import torch.nn.functional as F

    from stutter_tpu_torch.utils.benchmarking import bound

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
        queued_ms, queued_library_ms = time_turns(
            torch, lambda: mha.flash_mha_bias(q, k, v, ab),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=ab_q, scale=1.0), reps=8)
        n = B * H * L * 64  # q k^T and p v; q, k, v, out and ab once each
        numbers = timing(ms, plain_ms, *bound(4 * n * L, 4 * n * q.element_size() + 4 * ab.numel(),
                                              peak_flops(torch, dtype)), library_ms)
        say("mha_bias", shape=f"{B}x{H}x{L}x64", dtype=str(dtype).split(".")[-1],
            max_abs_err=f"{max_abs:.3e}", max_abs_tol=tol_abs, cosine_dist=f"{cos:.3e}",
            cosine_tol=tol_cos, ab_gb=f"{4 * ab.numel() / 1e9:.3f}", **shown(numbers),
            queued_ms=f"{queued_ms:.4f}", queued_library_ms=f"{queued_library_ms:.4f}",
            queued_tflops=f"{4 * n * L / queued_ms / 1e9:.1f}",
            queued_ab_tb_per_s=f"{4 * ab.numel() / queued_ms / 1e9:.3f}")
        check(max_abs <= tol_abs and cos <= tol_cos,
              f"flash_mha_bias disagrees with its plain version at {B}x{H}x{L} {dtype}")
        worst = max(worst, max_abs)
        headline = headline or numbers
        del q, k, v, bias, gate, mask, ab, ab_q, out, ref
        torch.cuda.empty_cache()
    return worst, headline


def probe_inputs(torch, g, B, L):
    """The probes' operands on the card: contiguous bf16 q, k, v (randn *
    0.3), bias, gate, and a key mask that cuts the last clip short."""
    H = 16
    q, k, v = ((torch.randn(B, H, L, 64, device="cuda", generator=g) * 0.3).to(torch.bfloat16)
               for _ in range(3))
    bias = torch.randn(H, L, L, device="cuda", generator=g)
    gate = torch.rand(B, H, L, device="cuda", generator=g)
    mask = torch.zeros(B, L, device="cuda")
    mask[-1, L // 2:] = -1e9
    return q, k, v, bias, gate, mask


def int8_operands_equal(torch, probes, k, v) -> bool:
    """Whether the int8 prologue's k and v and their scales equal the plain
    version's bit for bit, vq in its padded transposed layout."""
    kq, sk, vqt, sv = probes.quantize_kv(k, v)
    rkq, rsk, rvq, rsv = probes.quantize_kv_reference(k, v)
    return (torch.equal(kq, rkq) and torch.equal(sk, rsk) and torch.equal(sv, rsv)
            and torch.equal(vqt, probes.transpose_padded_reference(rvq)))


# the probes' cases (clips, frames), 16 heads: their CLIs' 30 s and 20 s
# defaults, then ragged lengths: under one 64-key tile, 64 * 16 + 1, one
# tile, one key past it and one past two
PROBE_CASES = ((25, 1504), (30, 1008), (3, 37), (4, 1025), (2, 64), (2, 65), (2, 129))


def phase_probe_kernels(torch, probes, card: str):
    """The int8 probe's kernels and the four softmax variants against their
    plain versions at ``PROBE_CASES``, the int8 operands bit-equal; returns
    {kernel: (worst max-abs error, the numbers at the 30 s case)}."""
    from stutter_tpu_torch.utils.benchmarking import BF16_PEAK, INT8_PEAK, bound

    g = torch.Generator(device="cuda").manual_seed(12)
    result = {"attn_int8": (0.0, None), "attn_softmax_variants": (0.0, None)}
    for B, L in PROBE_CASES:
        q, k, v, bias, gate, mask = args = probe_inputs(torch, g, B, L)
        check(int8_operands_equal(torch, probes, k, v),
              f"int8 k, v or their scales differ from the plain version's at {B}x16x{L}")
        n = B * 16 * L * 64  # q k^T and a v; q, k, v, out once, bias, gate, mask
        nbytes = 4 * n * 2 + 4 * (16 * L * L + B * 16 * L + B * L)
        runs = [("attn_int8", "int8", lambda: probes.int8_attention_long(*args),
                 lambda: probes.int8_attention_long_reference(*args), INT8_PEAK,
                 INT8_MAX_ABS, INT8_COSINE)]
        for name, (postnorm, chain) in probes.VARIANTS.items():
            runs.append(("attn_softmax_variants", name,
                         lambda pn=postnorm, c=chain: probes.softmax_variant_attention(*args, pn, c),
                         lambda pn=postnorm, c=chain: probes.softmax_variant_attention_reference(
                             *args, pn, c), BF16_PEAK, VARIANT_MAX_ABS, VARIANT_COSINE[name]))
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
        check_layer_norms(f"long_slice {mode}", counts, n_layers, len(lengths))
        check(counts["flash_mha_bias"] == hatch
              and counts["gated_relpos_attention"] == n_layers * len(lengths) - hatch
              and counts["pos_conv_residual"] == len(lengths),
              f"{mode}: launches {counts}, expected flash_mha_bias {hatch} and "
              f"gated_relpos_attention {n_layers * len(lengths) - hatch} and pos_conv_residual "
              f"{len(lengths)}")
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
            expected=f"{hatch},{n_layers * len(lengths) - hatch}",
            layer_norm_launches=counts["layer_norm"], layer_norm_fused=counts["layer_norm_fused"],
            fused_stem_calls=counts["wavlm_fused_stem"], wall_s=f"{wall:.2f}")
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
        for name, case in r["cases"].items():  # the verdicts on this card
            if "speedup_min" in case:
                say("probes", verdict=name, int8_speedup_min_vs_bf16=f"{case['speedup_min']:.4f}",
                    card=f'"{card}"')
            else:
                base = min(case["src_incumbent_ms"])
                say("probes", verdict=name, src_incumbent_ms=f"{base:.4f}",
                    **{f"{n}_over_incumbent": f"{min(case[n + '_ms']) / base:.4f}"
                       for n in VARIANTS}, card=f'"{card}"')
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
          == counts["wavlm_fused_stem"] == counts["pos_conv_residual"] == 0,
          "the Whisper path launched WavLM's kernels")
    # the encoder's 2 norms a layer (the residual add and the second norm in
    # one launch) and its final norm; the decoder's 3 a layer and its final norm
    enc, dec = cfg.encoder_layers, cfg.decoder_layers
    want = ((2 * enc + 3 * dec + 2) * batches, enc * batches)
    check((counts["layer_norm"], counts["layer_norm_fused"]) == want,
          f"{counts['layer_norm']} layer norms ({counts['layer_norm_fused']} fused) for "
          f"{batches} batches, expected {want}")
    # turbo: q, k, v, fc1, fc2 of each encoder layer; turbo_ffn: fc1, fc2; attn_o
    # and the decoder stay bf16
    int8 = INT8_GEMMS_A_LAYER["whisper"].get(extractor.preset, 0) * cfg.encoder_layers * batches
    check(counts["int8_gemm"] == int8,
          f"{counts['int8_gemm']} int8 GEMMs for {batches} batches, expected {int8}")
    say(phase, preset=extractor.preset, clips=len(meta), audio_s=f"{audio_s:.2f}",
        batches=batches, batch=pipe.batcher.batch_size_for(30.0),
        log_mel_launches=counts["whisper_log_mel"], flash_mha_launches=counts["flash_mha"],
        int8_gemms=counts["int8_gemm"], expected=f"{batches},{cfg.encoder_layers}x{batches}",
        layer_norm_launches=counts["layer_norm"], layer_norm_fused=counts["layer_norm_fused"],
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


def phase_whisper_gemm_stem(torch, model, card: str) -> None:
    """Whisper-large fast at 16 x 30 s with the stem as three shifted GEMMs
    (``gemm_stem``) against the conv stem: every pooled column within
    WHISPER_FAST_DECODER_COSINE (the fast decoder's bar, as for any change of
    the encoder's input), the stem's ms each way (CUDA events, in turns), and
    the gemm_stem run's launches: one log-mel call, one flash attention a
    layer."""
    from stutter_tpu_torch.frontend.whisper_frontend import whisper_features

    wave = whisper_test_clips(torch, 16, seed=5)
    n = model.cfg.encoder_layers
    idx = (n, n - 1, n - 2)
    rows, counts = {}, {}
    for gemm in (False, True):
        zero_counts()
        rows[gemm] = model.embed(whisper_features(wave), idx, idx, gemm_stem=gemm)
        torch.cuda.synchronize()
        counts[gemm] = read_counts()
        check(rows[gemm].shape == (6, 16, model.cfg.d_model)
              and bool(torch.isfinite(rows[gemm]).all()),
              f"whisper_gemm_stem: rows non-finite or of the wrong shape (gemm_stem={gemm})")
    on_card = wave.device.type == "cuda"
    check(counts[True]["flash_mha"] == n * on_card
          and counts[True]["whisper_log_mel"] == on_card,
          f"whisper_gemm_stem: launches {counts[True]}")
    worst = max(cosine_distance(rows[True][s, i], rows[False][s, i])
                for s in range(6) for i in range(16))
    mel = whisper_features(wave)
    with torch.inference_mode():
        conv_ms, gemm_ms = time_turns(torch, lambda: model.encoder.stem(mel),
                                      lambda: model.encoder.stem(mel, gemm_stem=True))
    say("whisper_gemm_stem", batch="16x30s", worst_pooled_cosine_vs_conv=f"{worst:.3e}",
        tol=WHISPER_FAST_DECODER_COSINE, conv_stem_ms=f"{conv_ms:.4f}",
        gemm_stem_ms=f"{gemm_ms:.4f}", flash_mha_launches=counts[True]["flash_mha"],
        log_mel_calls=counts[True]["whisper_log_mel"], card=f'"{card}"')
    check(worst <= WHISPER_FAST_DECODER_COSINE,
          f"whisper_gemm_stem: pooled rows {worst:.3e} from the conv stem's")


def phase_whisper_throughput(torch, extractor, work: Path, card: str) -> float:
    """The Whisper pipeline in the extractor's preset over 64 clips of 2-3 s
    in batches of 16 (the CLI's batch), after a warm batch, and one batch's
    device time; returns the clips/s."""
    import numpy as np

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.frontend.whisper_frontend import whisper_features
    from stutter_tpu_torch.utils.benchmarking import whisper_encoder_flops

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
    # the encoder's FLOPs over the whole embed's time (log-mel, encoder, decoder step)
    say_mfu("whisper-large", extractor.preset, f"{len(batch.lengths)}x30s",
            whisper_encoder_flops(cfg, len(batch.lengths)), encode_ms, card)
    say("whisper_throughput", preset=extractor.preset, clips=len(meta),
        audio_s=f"{audio_s:.1f}",
        wall_s=f"{wall:.3f}", clips_per_s=f"{len(meta) / wall:.2f}",
        audio_s_per_s=f"{audio_s / wall:.1f}", batch=f"{len(batch.lengths)}x30s",
        encode_device_ms=f"{encode_ms:.1f}",
        encode_clips_per_s=f"{len(batch.lengths) / (encode_ms / 1e3):.2f}",
        card=f'"{card}"')
    return len(meta) / wall


def phase_whisper_v3_slice(torch, work: Path, card: str, device: str = "cuda") -> dict:
    """Whisper large-v3 (128 mels; random weights, seed 0) fast through the
    pipeline on [whisper_slice]'s corpus (``phase_whisper_slice``: the store,
    one log-mel call, i.e. two kernel launches, and 32 flash_mha launches a
    batch, resume); then one 16 x 30 s batch, kernel path against the f32
    plain path (plain log-mel and attention, no TF32): the encoder columns
    within 1e-3, the decoder's within 5e-4 (PERF.md section 2's fast bars).
    Returns the slice's launch counts."""
    from stutter_tpu_torch.extract.pipeline import WhisperExtractor
    from stutter_tpu_torch.frontend.whisper_frontend import whisper_features
    from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel
    from stutter_tpu_torch.ops.flash_mha import flash_mha_reference
    from stutter_tpu_torch.ops.logmel import log_mel_spectrogram_reference
    from stutter_tpu_torch.ops.precision import no_tf32
    from stutter_tpu_torch.weights.convert import init_whisper

    cfg = WhisperConfig.large_v3()
    check(cfg.num_mel_bins == 128, f"large-v3 takes 128 mels, the config {cfg.num_mel_bins}")
    base = init_whisper(cfg, torch.Generator().manual_seed(0))
    fid_model = WhisperModel(cfg, device=device)
    fid_model.load_state_dict(base.state_dict())
    extractor = WhisperExtractor(base, device, preset="fast")  # casts to bf16
    del base
    counts = phase_whisper_slice(torch, extractor, work, phase="whisper_v3_slice")
    wave = whisper_test_clips(torch, 16, seed=5)
    n = cfg.encoder_layers
    idx = (n, n - 1, n - 2)
    fast = extractor.model.embed(whisper_features(wave, 128), idx, idx)
    with no_tf32():
        ref = fid_model.embed(log_mel_spectrogram_reference(wave, 128), idx, idx,
                              attention_fn=flash_mha_reference)
    check(fast.shape == (6, 16, cfg.d_model) and bool(torch.isfinite(fast).all()),
          f"whisper_v3: pooled rows {tuple(fast.shape)} or non-finite")
    d_enc, d_dec = worst_pooled(fast[:3], ref[:3]), worst_pooled(fast[3:], ref[3:])
    say("whisper_v3_slice", batch="16x30s", mels=128, encoder_cosine_vs_f32=f"{d_enc:.3e}",
        encoder_tol=FAST_F32_POOLED_COSINE, decoder_cosine_vs_f32=f"{d_dec:.3e}",
        decoder_tol=WHISPER_FAST_DECODER_COSINE, card=f'"{card}"')
    check(d_enc <= FAST_F32_POOLED_COSINE,
          f"whisper_v3: encoder columns {d_enc:.3e} from the f32 plain path")
    check(d_dec <= WHISPER_FAST_DECODER_COSINE,
          f"whisper_v3: decoder columns {d_dec:.3e} from the f32 plain path")
    return counts


# the gradient groups: encoder (the backbone above the frozen stem), layer
# weights, head
GRAD_GROUPS = {"encoder": lambda n: n.startswith("backbone."),
               "layer_weights": lambda n: n == "layer_weights",
               "head": lambda n: n.startswith("head.")}


def group_cosines(grads_a: dict, grads_b: dict) -> dict:
    """Gradient cosine distance per group (GRAD_GROUPS)."""
    import torch

    out = {}
    for group, member in GRAD_GROUPS.items():
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
    state = init_finetune_model(FinetuneConfig(model=mcfg, n_classes=4), device=device).state_dict()
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
        # autograd records every norm of a training step: the plain path
        check(counts["layer_norm"] == 0, f"{name} kernel step launched {counts['layer_norm']} "
              "layer norms")
        loss_rel = abs(loss_k - loss_p) / abs(loss_p)
        cos = group_cosines(g_k, g_p)
        say("finetune_path", batch=f"{B}x3s", dtype=name, layers=n_layers, loss=f"{loss_k:.6f}",
            plain_loss=f"{loss_p:.6f}", loss_rel=f"{loss_rel:.2e}", loss_rel_tol=loss_bar,
            **{f"{k}_grad_cosine_dist": f"{v:.3e}" for k, v in cos.items()},
            grad_cosine_tol=cos_bar, fwd_launches=counts["gated_relpos_attention"],
            bwd_launches=counts["gated_relpos_attention_bwd"],
            layer_norm_launches=counts["layer_norm"])
        check(np.isfinite(loss_k) and loss_rel <= loss_bar,
              f"{name}: kernel step loss {loss_k} vs plain {loss_p}")
        for group, d in cos.items():
            check(d <= cos_bar, f"{name}: {group} gradient cosine {d:.3e} > {cos_bar}")
        del trainer, runs, g_k, g_p


# the remat policies of [finetune_policies]: each against "layer"; then
# "layer" with int8_forward against the bf16 "layer" step
FT_POLICIES = ("layer", "layer_dots", "layer_probs", "dots", "nothing")


def group_norms(grads: dict) -> dict:
    """Each group's gradient norm (GRAD_GROUPS)."""
    import torch

    return {g: float(torch.cat([grads[n].float().flatten() for n in sorted(grads)
                                if member(n) and grads[n] is not None]).norm())
            for g, member in GRAD_GROUPS.items()}


def phase_finetune_policies(torch, attn, cfg_model, card: str, device: str = "cuda",
                            T: int = 51_280, B: int = 8):
    """WavLM-Large at B x 3 s, bf16, one fixed batch (no SpecAugment, no
    dropout), from one state: for each remat policy and for "layer" with
    int8_forward, one gradient pass (launches: 2 forwards and 1 backward a
    layer, 12 int8 products a layer with int8_forward) and two updates (ms
    each, peak memory). Each policy's gradients within FT_BF16_GRAD_COSINE
    of "layer"'s per group; int8_forward's per-group cosine distance and
    norm ratio against the bf16 step printed as
    scripts/finetune_int8_grad_check.py reports them and held finite, and its
    kernel path within FT_BF16_GRAD_COSINE of its plain path."""
    import dataclasses

    import numpy as np

    from stutter_tpu_torch.train.finetune import (
        FinetuneConfig,
        FinetuneTrainer,
        init_finetune_model,
    )

    mcfg = dataclasses.replace(cfg_model, apply_spec_augment=False)
    rng = np.random.RandomState(13)
    lengths = rng.randint(T * 5 // 8, T + 1, size=B)
    lengths[0] = T
    waves = (rng.randn(B, T) * 0.1 * (np.arange(T)[None] < lengths[:, None])).astype(np.float32)
    labels, cw = rng.randint(0, 4, size=B), np.array([1.0, 2.0, 0.5, 1.5], np.float32)
    batch = [torch.from_numpy(waves).to(device), torch.from_numpy(lengths).long().to(device),
             torch.from_numpy(labels).long().to(device), torch.ones(B, device=device)]
    state = init_finetune_model(FinetuneConfig(model=mcfg, n_classes=4), device=device).state_dict()
    n_layers = mcfg.num_hidden_layers
    on_card = device == "cuda"
    ref = None
    for policy, int8 in [(p, False) for p in FT_POLICIES] + [("layer", True)]:
        name = policy + ("+int8_forward" if int8 else "")
        cfg = FinetuneConfig(model=mcfg, n_classes=4, head_dropout=0.0,
                             activation_dtype=torch.bfloat16, remat_policy=policy,
                             int8_forward=int8)
        trainer = FinetuneTrainer(cfg, device=device, params=state)
        zero_counts()
        grads, loss, _ = trainer.gradients([batch], cw, normalize_in_graph=True)
        counts = read_counts()
        check(counts["gated_relpos_attention"] == 2 * n_layers * on_card
              and counts["gated_relpos_attention_bwd"] == n_layers * on_card
              and counts["int8_gemm"] == 12 * n_layers * int8,
              f"finetune_policies {name}: launches {counts}")
        fields = {}
        if ref is None:
            ref = (grads, float(loss))
        else:
            cos = group_cosines(grads, ref[0])
            fields.update({f"{k}_grad_cosine_dist": f"{v:.3e}" for k, v in cos.items()})
            if int8:
                base, mine = group_norms(ref[0]), group_norms(grads)
                fields.update({f"{k}_rel_norm": f"{mine[k] / base[k]:.4f}" for k in base})
                check(np.isfinite(float(loss)) and all(np.isfinite(v) for v in cos.values()),
                      f"finetune_policies {name}: non-finite loss or gradients")
                trainer.attention_fn = attn.gated_relpos_attention_reference
                zero_counts()
                plain, plain_loss, _ = trainer.gradients([batch], cw, normalize_in_graph=True)
                check(not read_counts()["gated_relpos_attention"],
                      "finetune_policies: the plain path launched the kernel")
                trainer.attention_fn = None
                vs_plain = group_cosines(grads, plain)
                fields.update({f"{k}_kernel_vs_plain": f"{v:.3e}" for k, v in vs_plain.items()})
                for group, d in vs_plain.items():
                    check(d <= FT_BF16_GRAD_COSINE,
                          f"finetune_policies {name}: {group} kernel vs plain {d:.3e}")
            else:
                for group, d in cos.items():
                    check(d <= FT_BF16_GRAD_COSINE,
                          f"finetune_policies {name}: {group} gradient cosine {d:.3e} vs layer")
        del grads
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            aux = trainer.step(waves, lengths, labels, cw)
            if on_card:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(aux["loss"]), f"finetune_policies {name}: update loss {aux}")
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
        say("finetune_policies", policy=name, batch=f"{B}x3s", loss=f"{float(loss):.6f}",
            layer_loss=f"{ref[1]:.6f}", update_ms=f"{ms[0]:.1f},{ms[1]:.1f}",
            peak_gib=f"{peak:.2f}", fwd_launches=counts["gated_relpos_attention"],
            bwd_launches=counts["gated_relpos_attention_bwd"], int8_gemms=counts["int8_gemm"],
            grad_cosine_tol=FT_BF16_GRAD_COSINE, **fields, card=f'"{card}"')
        del trainer
        if on_card:
            torch.cuda.empty_cache()


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
              "--max_length", str(max_length), "--device", device, "--devices", "1"]
    watch = ("backbone.feature_encoder.layers.0.weight", "backbone.layers.0.attention.q_w",
             f"backbone.layers.{n_layers - 1}.feed_forward.w2", "head.layers.0.w")

    def run(what, args, epochs, updates, microbatches):
        spy = TrainerSpy(torch, watch)
        zero_counts()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with spy.attached(), cli_dir(work, "finetune"):
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


# the downstream DSP on the card against the committed float64 goldens (the
# JAX tests' bars, tests/test_resample.py) and against the CPU tensor path
RESAMPLE_GOLDEN_ATOL, PITCH_GOLDEN_ATOL = 3e-6, 2e-4
RESAMPLE_CPU_ATOL, PITCH_CPU_ATOL = 1e-6, 1e-4
DSP_RATE_PAIRS = ((44100, 16000), (22050, 16000), (16000, 14400), (14400, 16000),
                  (16000, 17600), (8000, 16000))
AUGMENT_KINDS = ("speed", "noise", "pitch", "volume")
# SMOTE on the card against the CPU with the same draws (f32 sums in
# another order), a head fit on the card against the same fit on the CPU
# after 3 epochs, and the held-out balanced accuracy an MLP must reach on
# the separable synthetic set
SMOTE_MAX_ABS, HEAD_PROBA_MAX_ABS, HEAD_MIN_BALANCED_ACC = 1e-5, 1e-4, 0.9
# a KSF-scale training split: 4,096 x 1,024, 8 classes, the largest 25x the smallest.
# Equal neighbour indices on both devices are a fair check for this seed:
# among the classes SMOTE grows, the closest two of a row's four nearest
# squared distances lie 4.7e-3 apart, ~10x the f32 error of the distances
# (<= 5.6e-4 against float64; computed on the CPU)
HEAD_CLASS_COUNTS = (1550, 983, 615, 388, 245, 155, 98, 62)


class StageClock:
    """Wraps functions while the downstream CLI runs: each one's seconds
    (the device synchronised at its end), its calls, and its results."""

    def __init__(self, torch, device: str):
        self.torch, self.sync = torch, device == "cuda"
        self.seconds, self.calls, self.results = {}, {}, {}
        self._undo = []

    def wrap(self, owner, attr: str, stage: str) -> None:
        real = getattr(owner, attr)
        self.seconds.setdefault(stage, 0.0)
        self.calls.setdefault(stage, 0)
        self.results.setdefault(stage, [])

        def timed_call(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            if self.sync:
                self.torch.cuda.synchronize()
            self.seconds[stage] += time.perf_counter() - t0
            self.calls[stage] += 1
            self.results[stage].append((args, kwargs, out))
            return out

        setattr(owner, attr, timed_call)
        self._undo.append((owner, attr, real, attr in vars(owner)))

    def restore(self) -> None:
        for owner, attr, real, own in reversed(self._undo):
            if own:
                setattr(owner, attr, real)
            else:
                delattr(owner, attr)
        self._undo.clear()


def phase_downstream_dsp(torch, card: str, device: str = "cuda", clips: int = 256,
                         seconds: float = 3.0) -> dict:
    """resample (the six golden rate pairs) and pitch_shift (+-2) on the
    device against tests/goldens/dsp_goldens.npz and the CPU tensor path;
    then augment_audio over ``clips`` clips of ``seconds`` per kind, ms per
    clip (host clock, each call ends with its result on the host)."""
    import random

    import numpy as np

    from stutter_tpu_torch.ops.pitch import pitch_shift
    from stutter_tpu_torch.ops.resample import resample
    from stutter_tpu_torch.train.augment import augment_audio

    golden = np.load(ROOT / "tests" / "goldens" / "dsp_goldens.npz")
    x = torch.from_numpy(golden["input"])
    cases = [(f"resample_{o}_{n}", lambda t, o=o, n=n: resample(t, o, n),
              RESAMPLE_GOLDEN_ATOL, RESAMPLE_CPU_ATOL) for o, n in DSP_RATE_PAIRS]
    cases += [(f"pitch_{s}", lambda t, s=s: pitch_shift(t, 16000, s),
               PITCH_GOLDEN_ATOL, PITCH_CPU_ATOL) for s in (-2, 2)]
    errs = {}
    for name, fn, golden_atol, cpu_atol in cases:
        on_device = fn(x.to(device)).cpu()
        on_cpu = fn(x)
        want = torch.from_numpy(golden[name])
        check(on_device.shape == on_cpu.shape == want.shape, f"{name}: shape {on_device.shape}")
        e_golden = float((on_device.double() - want).abs().max())
        e_cpu = float((on_device - on_cpu).abs().max())
        check(e_golden <= golden_atol, f"{name}: {e_golden:.2e} from the golden > {golden_atol}")
        check(e_cpu <= cpu_atol, f"{name}: {e_cpu:.2e} from the CPU path > {cpu_atol}")
        errs[name] = (e_golden, e_cpu)
    rs = [v for k, v in errs.items() if k.startswith("resample")]
    ps = [v for k, v in errs.items() if k.startswith("pitch")]
    say("downstream_dsp", device=device,
        resample_golden_err=f"{max(e for e, _ in rs):.2e}", resample_golden_tol=RESAMPLE_GOLDEN_ATOL,
        resample_cpu_err=f"{max(e for _, e in rs):.2e}", resample_cpu_tol=RESAMPLE_CPU_ATOL,
        pitch_golden_err=f"{max(e for e, _ in ps):.2e}", pitch_golden_tol=PITCH_GOLDEN_ATOL,
        pitch_cpu_err=f"{max(e for _, e in ps):.2e}", pitch_cpu_tol=PITCH_CPU_ATOL)

    rng = np.random.RandomState(21)
    T = int(seconds * 16000)
    t = np.arange(T) / 16000
    waves = (0.4 * np.sin(2 * np.pi * rng.uniform(100, 600, (clips, 1)) * t)
             + 0.05 * rng.randn(clips, T)).astype(np.float32)
    ms = {}
    for kind in AUGMENT_KINDS:
        r = random.Random(7)
        for w in waves[:4]:  # warm: kernels, cuDNN's plans, the allocator
            augment_audio(w, 16000, kind, rng=r, device=device)
        t0 = time.perf_counter()
        for w in waves:
            y = augment_audio(w, 16000, kind, rng=r, device=device)
        ms[kind] = (time.perf_counter() - t0) * 1e3 / clips
        check(y.shape == w.shape and bool(np.isfinite(y).all()) and np.abs(y).max() <= 1.0,
              f"augment_audio {kind}: shape {y.shape} or values out of range")
    say("downstream_dsp", clips=clips, seconds=seconds,
        **{f"{k}_ms_per_clip": f"{v:.3f}" for k, v in ms.items()}, card=f'"{card}"')
    return ms


def phase_downstream_heads(torch, card: str, device: str = "cuda",
                           counts=HEAD_CLASS_COUNTS, dim: int = 1024,
                           held_out: int = 128) -> dict:
    """SMOTE and the heads at a KSF-scale training split: separable
    synthetic embeddings, ``counts`` rows a class. SMOTE on the device
    against smote_interpolate on the CPU with the same draws (values and
    neighbour indices); a 3-epoch HeadClassifier fit on the device against
    the same fit on the CPU; the default MLP (hidden 256, 200 epochs) on the
    SMOTE-balanced set, its held-out balanced accuracy and seconds."""
    import numpy as np

    from stutter_tpu_torch.train.classifiers import make_classifier
    from stutter_tpu_torch.train.heads import HeadClassifier, HeadConfig
    from stutter_tpu_torch.train.metrics import classification_metrics
    from stutter_tpu_torch.train.smote import (
        apply_smote_oversampling,
        smote_draws,
        smote_interpolate,
        smote_neighbors,
    )

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rng = np.random.RandomState(31)
    n_classes = len(counts)
    centres = rng.randn(n_classes, dim) * 0.3
    y = np.repeat(np.arange(n_classes), counts)
    X = (centres[y] + rng.randn(len(y), dim)).astype(np.float32)
    y_held = np.repeat(np.arange(n_classes), held_out)
    X_held = (centres[y_held] + rng.randn(len(y_held), dim)).astype(np.float32)

    t0 = time.perf_counter()
    Xs, ys = apply_smote_oversampling(X, y, k_neighbors=3, random_state=42, device=device)
    smote_s = time.perf_counter() - t0
    majority, k = max(counts), min(3, min(counts) - 1)
    check(np.bincount(ys).tolist() == [majority] * n_classes,
          f"SMOTE left counts {np.bincount(ys).tolist()}")
    check(np.array_equal(Xs[: len(X)], X), "SMOTE moved the original rows")
    generator, offset, smote_err = torch.Generator().manual_seed(42), len(X), 0.0
    for cls in sorted(set(y.tolist()), key=str):
        n_new = majority - counts[cls]
        if n_new <= 0:
            continue
        block = torch.from_numpy(X[y == cls])
        on_cpu = smote_interpolate(block, k, *smote_draws(generator, len(block), k, n_new))
        smote_err = max(smote_err, float(np.abs(Xs[offset: offset + n_new] - on_cpu.numpy()).max()))
        offset += n_new
        check(torch.equal(smote_neighbors(block.to(device), k).cpu(), smote_neighbors(block, k)),
              f"class {cls}: SMOTE's neighbours differ between {device} and the CPU")
    check(smote_err <= SMOTE_MAX_ABS, f"SMOTE {device} vs CPU: {smote_err:.2e} > {SMOTE_MAX_ABS}")

    cfg = HeadConfig(dim, n_classes, (256,), dropout=0.0, epochs=3, seed=0)
    probas = {}
    for where in (device, "cpu"):
        probas[where] = HeadClassifier(cfg, device=where).fit(X, y).predict_proba(X_held)
    proba_err = float(np.abs(probas[device] - probas["cpu"]).max())
    check(proba_err <= HEAD_PROBA_MAX_ABS,
          f"HeadClassifier {device} vs CPU predict_proba {proba_err:.2e} > {HEAD_PROBA_MAX_ABS}")

    mlp = make_classifier("mlp", dim, n_classes, device=device)
    sync()
    t0 = time.perf_counter()
    mlp.fit(Xs, ys)
    sync()
    fit_s = time.perf_counter() - t0
    bal = classification_metrics(y_held, mlp.predict(X_held), n_classes)["balanced_accuracy"]
    check(bal >= HEAD_MIN_BALANCED_ACC, f"MLP held-out balanced accuracy {bal:.4f} "
          f"< {HEAD_MIN_BALANCED_ACC}")
    steps = mlp.cfg.epochs * (len(ys) // mlp.cfg.batch_size)
    say("downstream_heads", device=device, train=f"{len(y)}x{dim}", classes=n_classes,
        counts=",".join(map(str, counts)), smote_rows=len(ys), smote_s=f"{smote_s:.3f}",
        smote_err=f"{smote_err:.2e}", smote_tol=SMOTE_MAX_ABS, neighbours="equal",
        head_proba_err=f"{proba_err:.2e}", head_proba_tol=HEAD_PROBA_MAX_ABS,
        mlp_fit_s=f"{fit_s:.3f}", mlp_steps=steps, mlp_ms_per_step=f"{fit_s * 1e3 / steps:.3f}",
        mlp_held_out_balanced_acc=f"{bal:.4f}", card=f'"{card}"')
    return {"smote_s": smote_s, "fit_s": fit_s}


def phase_downstream(torch, work: Path, card: str, device: str = "cuda",
                     durations=(2.0, 3.0)) -> dict:
    """The downstream stack end to end at WavLM-Large (random weights, seed
    0, fast): a KSF-layout corpus with two classes of 48 training clips and
    two of 16, extracted by cli.extract_wavlm; cli.train with the MLP,
    augmentation factor 2 and threshold 20 (64 clips re-extracted through
    the gated attention kernel); then run_grid_training with the two heads.
    Checks the launches, the augmented rows, SMOTE's balance, the JAX
    package's output tree and the balanced accuracies; prints each stage's
    seconds. Returns the re-extraction's launch counts."""
    import logging
    import math

    import numpy as np

    from stutter_tpu_torch.cli import extract_wavlm as extract_cli
    from stutter_tpu_torch.cli import train as train_cli
    from stutter_tpu_torch.extract.pipeline import WavLMExtractor
    from stutter_tpu_torch.models.wavlm import WavLMConfig
    from stutter_tpu_torch.train import augment_extract, classifiers, heads, trainer
    from stutter_tpu_torch.train.classifiers import GRID_MODELS_JAX
    from stutter_tpu_torch.train.trainer import TrainConfig, run_grid_training

    on_card = device == "cuda"
    n_layers = WavLMConfig.large().num_hidden_layers
    rng = np.random.RandomState(8)
    train_labels = ["no_disfluency"] * 48 + ["block"] * 48 + ["prolongation"] * 16 \
        + ["sound_repetition"] * 16
    rng.shuffle(train_labels)
    labels = {"train": train_labels, "test": list(KSF_LABELS) * 6, "devel": list(KSF_LABELS) * 6}
    corpus, store, results = work / "ds_corpus", work / "ds_store", work / "ds_results"
    audio_s = write_corpus(corpus, {s: len(v) for s, v in labels.items()}, durations, seed=8,
                           labels=labels)
    stages = {}
    t0 = time.perf_counter()
    with cli_dir(work, "wavlm_embedding"):
        rc = extract_cli.main(["--data_dir", str(corpus), "--output_dir", str(store / "wavlm"),
                               "--random_init", "--device", device, "--devices", "1"])
    stages["extract"] = time.perf_counter() - t0
    check(rc == 0, f"cli.extract_wavlm returned {rc}")

    try:
        import matplotlib  # noqa: F401
        plots = True
    except ImportError:
        plots = False
    warned = []

    class Catch(logging.Handler):
        def emit(self, record):
            if "matplotlib" in record.getMessage():
                warned.append(record.getMessage())

    catch = Catch()
    logging.getLogger().addHandler(catch)
    clock = StageClock(torch, device)
    clock.wrap(WavLMExtractor, "submit", "reextract_submit")
    clock.wrap(augment_extract, "augment_audio", "augment_dsp")
    clock.wrap(augment_extract, "_embed_waves", "reextract")
    clock.wrap(trainer, "apply_data_augmentation", "augmentation")
    clock.wrap(classifiers, "apply_smote_oversampling", "smote")
    clock.wrap(heads.HeadClassifier, "fit", "head_fit")
    zero_counts()
    try:
        t0 = time.perf_counter()
        with cli_dir(work, "model_training"):
            rc = train_cli.main(["--embeddings_dir", str(store), "--results_dir", str(results),
                                 "--model_type", "wavlm", "--classifier", "mlp",
                                 "--augmentation_factor", "2", "--minority_threshold", "20",
                                 "--random_init", "--device", device, "--devices", "1"])
        stages["train_cli"] = time.perf_counter() - t0
        counts = read_counts()
    finally:
        clock.restore()
        logging.getLogger().removeHandler(catch)
    check(rc == 0, f"cli.train returned {rc}")
    batches = clock.calls["reextract_submit"]
    launches = counts["gated_relpos_attention"]
    check(batches == math.ceil(64 / 64), f"the re-extraction submitted {batches} batches")
    check(launches == n_layers * batches * on_card,
          f"gated attention launched {launches} times for {batches} re-extraction batches, "
          f"expected {n_layers}x{batches}")
    check_wavlm_kernels("the downstream run", counts, batches, on_card, n_layers)
    (aug_args, _, (meta_out, emb_out)), = clock.results["augmentation"]
    n_aug = len(meta_out) - len(aug_args[0])
    (waves_args, _, embedded), = clock.results["reextract"]
    check(n_aug == 64 and len(waves_args[1]) == 64
          and all(len(v) == len(meta_out) for v in emb_out.values())
          and all(r.get("augmented") for r in meta_out[len(aug_args[0]):]),
          f"{n_aug} augmented rows, {len(waves_args[1])} re-extracted clips, expected 64")
    check(all(bool(np.isfinite(v).all()) for v in embedded.values()),
          "non-finite re-extracted embeddings")
    for _, _, (Xr, yr) in clock.results["smote"]:
        check(len(set(np.bincount(yr).tolist())) == 1, f"SMOTE left counts {np.bincount(yr)}")
    check(bool(warned) != plots,
          f"matplotlib {'present' if plots else 'absent'}, warnings {warned}")
    # the extractor's default layers: the last three hidden states and the middle one
    layers = sorted({f"layer_{i}" for i in (n_layers, n_layers - 1, n_layers - 2,
                                             (n_layers + 1) // 2)})
    check(sorted(p.name for p in results.iterdir() if p.is_dir()) == layers,
          f"layer dirs {sorted(p.name for p in results.iterdir())}, expected {layers}")
    check(clock.calls["smote"] == clock.calls["head_fit"] == len(layers),
          f"{clock.calls['smote']} SMOTE calls and {clock.calls['head_fit']} fits "
          f"for {len(layers)} layers")
    expect = ["all_results_comparison.csv", "layer_comparison_summary.csv", "final_summary.txt",
              "best_per_layer.json"] + (["layer_comparison_balanced_accuracy.png"] if plots else [])
    for layer in layers:
        tag = f"{layer}_mlp"
        expect += [f"{layer}/{tag}_classification_report.txt",
                   f"{layer}/wavlm_{tag}_model.npz", f"{layer}/wavlm_{tag}_info.json"]
        expect += [f"{layer}/{tag}_confusion_matrix.png",
                   f"{layer}/{tag}_per_class_metrics.png"] if plots else []
    missing = [f for f in expect if not (results / f).is_file()]
    check(not missing, f"cli.train outputs missing: {missing}")
    best = json.loads((results / "best_per_layer.json").read_text())

    grid_dir = work / "ds_grid"
    t0 = time.perf_counter()
    grid = run_grid_training(TrainConfig(embeddings_dir=str(store), results_dir=str(grid_dir),
                                         model_type="wavlm", make_plots=plots, device=device),
                             model_names=GRID_MODELS_JAX)
    stages["grid"] = time.perf_counter() - t0
    check(sorted(grid) == layers, f"grid layers {sorted(grid)}")
    for layer, r in grid.items():
        key = r["configuration"]
        for f in (f"{key}_classification_report.txt", f"wavlm_{layer}_{key}_model.npz",
                  f"wavlm_{layer}_{key}_info.json") + (
                      (f"{layer}_model_comparison.png", f"{key}_confusion_matrix.png")
                      if plots else ()):
            check((grid_dir / layer / f).is_file(), f"grid output {layer}/{f} missing")
    for f in ("all_results_comparison.csv", "layer_comparison_summary.csv", "final_summary.txt"):
        check((grid_dir / f).is_file(), f"grid output {f} missing")
    accs = [r["balanced_accuracy"] for r in best.values()] + \
        [r["balanced_accuracy"] for r in grid.values()]
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in accs), f"balanced accuracies {accs}")
    say("downstream", corpus_clips=sum(len(v) for v in labels.values()),
        corpus_audio_s=f"{audio_s:.1f}", augmented_rows=n_aug, reextract_batches=batches,
        gated_launches=launches, expected=f"{n_layers}x{batches}", plots=plots,
        balanced_acc=",".join(f"{best[k]['balanced_accuracy']:.4f}" for k in layers),
        grid_balanced_acc=",".join(f"{grid[k]['balanced_accuracy']:.4f}" for k in layers),
        card=f'"{card}"')
    seconds = dict(extract=stages["extract"], train_cli=stages["train_cli"],
                   augmentation=clock.seconds["augmentation"],
                   augment_dsp=clock.seconds["augment_dsp"], reextract=clock.seconds["reextract"],
                   smote=clock.seconds["smote"], head_fits=clock.seconds["head_fit"],
                   grid=stages["grid"])
    say("downstream", **{f"{k}_s": f"{v:.2f}" for k, v in seconds.items()}, card=f'"{card}"')
    return counts


def stem_flops_bytes(st, B: int, T: int, weights, table):
    """The fused stem's operations, the bytes of its inputs and output (each
    once), the bytes the per-layer design also moves (each intermediate
    layer's bf16 frames written once and read once), and the conv layers'
    weight bytes read from L2 (once a cluster of CTAs, ``st.conv_plan``)."""
    lengths = st.stem_layer_lengths(T)
    taps = (10,) + tuple(k * st.CHANNELS for k in (3, 3, 3, 3, 2, 2))
    flops = sum(2 * B * n * k * st.CHANNELS for n, k in zip(lengths, taps))
    io = 4 * B * T + 2 * weights.numel() + 4 * table.numel() + 2 * B * lengths[-1] * st.CHANNELS
    between = sum(2 * 2 * B * n * st.CHANNELS for n in lengths[:-1])
    weight_reads = sum(B * tiles // st.CONV_CLUSTER * 2 * k * st.CHANNELS ** 2
                       for (_, _, tiles), k in zip(st.conv_plan(T), (3, 3, 3, 3, 2, 2)))
    return flops, io, between, weight_reads


def seeded_stem_layers(torch):
    """WavLM-Large's conv stem in bf16 on the card: weights drawn like
    init_wavlm's, biases and norm affines given seeded noise so that every
    term of the epilogue is exercised."""
    from stutter_tpu_torch.models.wavlm import ConvFeatureEncoder, WavLMConfig

    g = torch.Generator().manual_seed(0)
    stem = ConvFeatureEncoder(WavLMConfig.large())
    with torch.no_grad():
        for layer in stem.layers:
            c_out, c_in, k = layer.weight.shape
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=g) * (c_in * k) ** -0.5)
            layer.bias.copy_(torch.randn(c_out, generator=g) * 0.1)
            layer.norm_scale.copy_(1.0 + 0.1 * torch.randn(c_out, generator=g))
            layer.norm_bias.copy_(0.1 * torch.randn(c_out, generator=g))
    return stem.to("cuda", torch.bfloat16)


# the stem's cases (clips, samples, timed): the 3 s and 30 s buckets; then one
# clip, a one-frame clip (T = 400), an unaligned length, and 1 s clips, whose
# layers 1 and 6 leave a cluster with a CTA of no rows
STEM_CASES = ((128, 51_280, True), (12, 481_360, True), (1, 51_280, False), (3, 400, False),
              (5, 51_417, False), (2, 16_080, False))


def phase_stem(torch, card: str):
    """The fused stem kernel against its plain version, and its end-masked
    frames against the plain ConvFeatureEncoder (cuDNN, per-layer masking),
    at ``STEM_CASES`` with ragged lengths, a silent clip and a clip of 4
    frames; median times of all three at the two buckets. Returns (worst
    max-abs error, the numbers at the 3 s bucket)."""
    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
    from stutter_tpu_torch.models.wavlm import WavLMConfig, wavlm_feature_lengths
    from stutter_tpu_torch.ops import wavlm_stem as st
    from stutter_tpu_torch.utils.benchmarking import BF16_PEAK, bound

    cfg = WavLMConfig.large()
    stem = seeded_stem_layers(torch)
    weights, table = stem.packed()
    g = torch.Generator(device="cuda").manual_seed(3)
    worst, headline = 0.0, None
    for B, T, timed in STEM_CASES:
        lengths = torch.randint(T // 4, T + 1, (B,), device="cuda", generator=g)
        lengths[0] = T
        if B > 2:
            lengths[1], lengths[2] = T, min(T, 400 + 3 * 320)  # full, silent, 4 frames
        wave = torch.randn(B, T, device="cuda", generator=g) * 0.1
        wave = wave * (torch.arange(T, device="cuda")[None] < lengths[:, None])
        if B > 2:
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
        fields = dict(shape=f"{B}x{T}", frames=L, max_abs_err=f"{max_abs:.3e}",
                      nrmse=f"{nrmse:.3e}", nrmse_tol=STEM_NRMSE, cosine_dist=f"{cos:.3e}",
                      cosine_tol=STEM_COSINE, vs_convfeature_nrmse=f"{lib_nrmse:.3e}",
                      vs_convfeature_cosine=f"{lib_cos:.3e}")
        if timed:
            ms, plain_ms, library_ms = time_turns(
                torch, lambda: st.wavlm_fused_stem(wave, weights, table),
                lambda: st.wavlm_fused_stem_reference(wave, weights, table),
                lambda: stem(wave, lengths))
            queued_ms, = time_turns(torch, lambda: st.wavlm_fused_stem(wave, weights, table),
                                    runs=10, reps=8)
            flops, io, between, weight_reads = stem_flops_bytes(st, B, T, weights, table)
            bound_ms, bound_by = bound(flops, io, BF16_PEAK)
            design_ms, _ = bound(flops, io + between, BF16_PEAK)
            fields.update(ms=f"{ms:.4f}", queued_ms=f"{queued_ms:.4f}",
                          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
                          tflop=f"{flops / 1e12:.4f}", bound_ms=f"{bound_ms:.4f}",
                          bound_by=bound_by, bound_with_intermediates_ms=f"{design_ms:.4f}",
                          weight_reads_gb=f"{weight_reads / 1e9:.3f}", card=f'"{card}"')
            if headline is None:
                headline = timing(ms, plain_ms, bound_ms, bound_by, library_ms)
                headline["queued_ms"] = queued_ms
        say("stem", **fields)
        check(nrmse <= STEM_NRMSE and cos <= STEM_COSINE,
              f"stem kernel disagrees with its plain version at {B}x{T}")
        check(lib_nrmse <= STEM_NRMSE and lib_cos <= STEM_COSINE,
              f"stem kernel disagrees with ConvFeatureEncoder at {B}x{T}")
        worst = max(worst, max_abs)
        del out, ref, lib, masked, d
        torch.cuda.empty_cache()
    return worst, headline


# the positional conv's cases (clips, frames, width, timed): the main path's
# shapes (WavLM-Large's 3 s, 20 s and 30 s buckets at 1024, XLS-R 2B's long
# buckets at 1920); then the edges of the kernel's 256-frame tile and its
# 64-row sub-tiles, and one clip
POS_CONV_CASES = ((80, 160, 1024, True), (12, 1008, 1024, True), (8, 1504, 1024, True),
                  (12, 1008, 1920, True), (8, 1504, 1920, True),
                  *((3, L, 1920, False) for L in (1, 17, 63, 64, 65, 127, 129, 200)),
                  *((3, L, 1024, False) for L in (1, 65, 129, 257)), (1, 333, 1920, False))


def pos_conv_flops_bytes(B: int, L: int, D: int, groups: int = 16) -> tuple[int, int]:
    """The positional conv's operations at its true width and the bytes of
    its inputs and output (hidden read and the result written once each, the
    weights and the bias read once)."""
    Cg = D // groups
    return 2 * B * L * D * Cg * 128, 2 * 2 * B * L * D + 2 * D * Cg * 128 + 4 * D


def seeded_pos_conv(torch, D: int, groups: int = 16):
    """A PosConvEmbedding of D channels in bf16 on the card, its products
    ~N(0, 0.25) on inputs ~N(0, 0.25), the bias seeded noise."""
    import dataclasses

    from stutter_tpu_torch.models.wavlm import PosConvEmbedding, WavLMConfig

    cfg = dataclasses.replace(WavLMConfig.large(), hidden_size=D,
                              num_conv_pos_embedding_groups=groups)
    g = torch.Generator().manual_seed(D)
    module = PosConvEmbedding(cfg)
    with torch.no_grad():
        module.weight.copy_(torch.randn(module.weight.shape, generator=g)
                            * (module.weight.shape[1] * 128) ** -0.5)
        module.bias.copy_(torch.randn(D, generator=g) * 0.1)
    return module.to("cuda", torch.bfloat16)


def phase_pos_conv(torch, card: str):
    """The positional conv kernel (hidden + pos_conv(hidden) in one call)
    against its plain version (f32 conv, the same roundings), an f32
    reference (no rounding) and the library path it replaced (cuDNN's bf16
    grouped conv, then the f32 epilogue and the add), at ``POS_CONV_CASES``
    with the clips' tails zeroed at odd frame counts; median times of all
    three at the main path's shapes, and of the kernel and the weight pack
    alone. Returns (worst max-abs error, the
    numbers at XLS-R 2B's 30 s bucket, the numbers at each timed shape)."""
    from stutter_tpu_torch.ops import pos_conv as pc
    from stutter_tpu_torch.ops.precision import no_tf32
    from stutter_tpu_torch.utils.benchmarking import BF16_PEAK, bound

    modules = {D: seeded_pos_conv(torch, D) for D in (1024, 1920)}
    g = torch.Generator(device="cuda").manual_seed(5)
    worst, cases = 0.0, {}
    for B, L, D, timed_case in POS_CONV_CASES:
        module = modules[D]
        hidden = torch.randn(B, L, D, device="cuda", generator=g) * 0.5
        if B > 1:  # tails zeroed as the callers zero padded frames: odd counts
            for b, n in enumerate((L, max(1, L // 2) | 1, max(1, L - 7) | 1)[:B]):
                hidden[b, n:] = 0.0
        hidden = hidden.to(torch.bfloat16)
        before = pc.pos_conv_residual.launches
        out = module(hidden)
        check(pc.pos_conv_residual.launches == before + 1,
              "PosConvEmbedding did not take the kernel on a bf16 batch")
        ref = pc.pos_conv_residual_reference(hidden, module.weight, module.bias, module.groups)
        with no_tf32():
            y = torch.nn.functional.conv1d(hidden.float().transpose(1, 2), module.weight.float(),
                                           padding=64, groups=module.groups)[:, :, :L]
        exact = hidden.float() + torch.nn.functional.gelu(
            y + module.bias.float()[None, :, None]).transpose(1, 2)
        lib = module.plain(hidden)
        torch.cuda.synchronize()
        check(out.shape == hidden.shape and out.dtype == torch.bfloat16,
              f"pos_conv output {out.dtype} {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "pos_conv output has non-finite values")
        d = out.float() - ref.float()
        max_abs = float(d.abs().max())
        cos = cosine_distance(out.float(), ref.float())
        f32_max_abs = float((out.float() - exact).abs().max())
        lib_max_abs = float((lib.float() - ref.float()).abs().max())
        fields = dict(shape=f"{B}x{L}x{D}", max_abs_err=f"{max_abs:.3e}",
                      max_abs_tol=BF16_MAX_ABS, cosine_dist=f"{cos:.3e}", cosine_tol=BF16_COSINE,
                      vs_f32_max_abs=f"{f32_max_abs:.3e}",
                      library_vs_plain_max_abs=f"{lib_max_abs:.3e}")
        if timed_case:
            ms, plain_ms, library_ms = time_turns(
                torch, lambda: module(hidden),
                lambda: pc.pos_conv_residual_reference(hidden, module.weight, module.bias,
                                                       module.groups),
                lambda: module.plain(hidden))
            # the module's call packs the weight each time; the kernel alone
            # takes a packed weight
            weights, bias = pc.pack_pos_conv_weights(module.weight), module.bias.float()
            queued_ms, kernel_ms, pack_ms = time_turns(
                torch, lambda: module(hidden),
                lambda: pc.pos_conv_residual(hidden, weights, bias, module.groups),
                lambda: pc.pack_pos_conv_weights(module.weight), runs=10, reps=8)
            flops, nbytes = pos_conv_flops_bytes(B, L, D)
            bound_ms, bound_by = bound(flops, nbytes, BF16_PEAK)
            fields.update(ms=f"{ms:.4f}", queued_ms=f"{queued_ms:.4f}",
                          kernel_queued_ms=f"{kernel_ms:.4f}", pack_queued_ms=f"{pack_ms:.4f}",
                          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
                          tflop=f"{flops / 1e12:.4f}", bound_ms=f"{bound_ms:.4f}",
                          bound_by=bound_by, roofline_pct=f"{100 * bound_ms / kernel_ms:.1f}",
                          card=f'"{card}"')
            cases[f"{B}x{L}x{D}"] = dict(timing(ms, plain_ms, bound_ms, bound_by, library_ms),
                                         queued_ms=queued_ms, kernel_queued_ms=kernel_ms,
                                         pack_queued_ms=pack_ms)
        say("pos_conv", **fields)
        check(max_abs <= BF16_MAX_ABS and cos <= BF16_COSINE,
              f"pos_conv kernel disagrees with its plain version at {B}x{L}x{D}")
        worst = max(worst, max_abs)
        del out, ref, exact, lib, y, d, hidden
        torch.cuda.empty_cache()
    say("pos_conv", launches=pc.pos_conv_residual.launches)
    return worst, cases["8x1504x1920"], cases


# the layer norm kernel against its plain version: the residual sum is the
# same bf16 add, so bit-equal; the statistics sum in another order, so the
# f32 output moves by a few f32 steps of its terms ((v - mean) r scale,
# |.| < ~8, and the bias): an output may flip its last bf16 bit, rarely, and
# one that the bias cancels to near 0 may move by a few of its own small
# steps, each within 2^-16. The share of flipped outputs read 1.3e-6 to
# 1.3e-5 in every case, a one-pass variance 1.7e-4 to 6.8e-3 at the edge
# rows. On rows whose every sum is exact in f32 in any order
# (``ln_exact_inputs``) nothing but the arithmetic after the statistics can
# differ: there the kernel is the plain version bit for bit, where a build
# with fused multiply-adds flips outputs (PERF.md §6 PR 24). A model
# batch's pooled rows read 1.1e-6 from the gate-closed batch, with either
# build: that bar catches gross faults only
LN_MAX_ULPS, LN_NEAR_ZERO_ABS, LN_FLIP_SHARE = 1, 2.0**-16, 1e-4
LN_POOLED_COSINE = 1e-5
# (B, L, D) at the main path's shapes, every one timed in both forms:
# WavLM-Large's 3, 20 and 30 s buckets, XLS-R 2B's 20 and 30 s ones,
# Whisper-large's 30 s window, the feature projection's 512 channels at 3
# and 30 s
LN_CASES = ((80, 149, 1024), (12, 1008, 1024), (8, 1504, 1024), (12, 1008, 1920),
            (8, 1504, 1920), (16, 1500, 1280), (80, 149, 512), (8, 1504, 512))
L2_BYTES = 50e6  # the H100's L2


def device_turns(torch, *fns, runs: int = 10, reps: int = 8):
    """Median device ms per launch of each function, in turns: the stream
    first sleeps ~1 ms, so that the host has queued all ``reps`` launches
    before the first event runs, and the events enclose the device's work
    alone."""
    for _ in range(3):
        for fn in fns:
            fn()
    times = tuple([] for _ in fns)
    for _ in range(runs):
        for fn, acc in zip(fns, times):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            e1.synchronize()
            acc.append(e0.elapsed_time(e1) / reps)
    return tuple(sorted(t)[len(t) // 2] for t in times)


def bf16_ulps(torch, a, b):
    """Each element's distance in bf16 steps between two bf16 tensors (the
    bit patterns laid on one ordered integer line, -0 on +0)."""
    def line(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)

    return (line(a) - line(b)).abs()


def ln_inputs(torch, B: int, L: int, D: int, g, edges: bool):
    """x and delta [B, L, D] bf16 on the card, like a residual stream and an
    attention output; with ``edges``: a constant row, rows about +1e4 and
    -1e4, a row of ~1e-3, and each clip's tail zeroed from an odd frame on
    (padding)."""
    x = (torch.randn(B, L, D, device="cuda", generator=g) * 2.0
         + torch.randn(B, L, 1, device="cuda", generator=g))
    delta = torch.randn(B, L, D, device="cuda", generator=g) * 0.5
    if edges:
        rows, drows = x.view(-1, D), delta.view(-1, D)
        n = rows.shape[0]
        rows[n // 2], drows[n // 2] = 3.0, 0.0
        if n > 3:
            rows[n // 3] = rows[n // 3] * 1e-3 + 1e4
            rows[n // 4] = rows[n // 4] * 1e3 - 1e4
            drows[n // 4] *= 1e4
            rows[n - 1] *= 1e-3
        for b in range(1, B):
            x[b, (L // (b + 1)) | 1:] = 0.0
            delta[b, (L // (b + 1)) | 1:] = 0.0
    return x.to(torch.bfloat16), delta.to(torch.bfloat16)


def ln_exact_inputs(torch, B: int, L: int, D: int, g):
    """x and delta [B, L, D] bf16 on the card whose rows, and the rows of
    their sum, are D / 2 multiples of 2^-3 of at most 32 steps (64 in the
    sum) and their negatives, shuffled alike, each row scaled by its own
    power of two from 2^-4 to 2^4: the sum is exact, its mean 0, and the sum
    of its squares below 2^24 steps, so every statistic is exact in f32 in
    any order."""
    rows = B * L

    def half():
        return torch.randint(-32, 33, (rows, D // 2), device="cuda", generator=g).float() / 8

    scale = torch.exp2(torch.randint(-4, 5, (rows, 1), device="cuda", generator=g).float())
    order = torch.argsort(torch.rand(rows, D, device="cuda", generator=g), dim=1)
    x, delta = ((torch.gather(torch.cat([h, -h], dim=1), 1, order) * scale)
                .view(B, L, D).to(torch.bfloat16) for h in (half(), half()))
    return x, delta


def cycling(fn, copies: list):
    """fn called on the next of ``copies`` at each call."""
    state = {"i": 0}

    def call():
        state["i"] = (state["i"] + 1) % len(copies)
        return fn(*copies[state["i"]])

    return call


def phase_layer_norm(torch, card: str):
    """The layer norm kernel, alone and with the residual add, against its
    plain version (the models' f32 statistics) and ``F.layer_norm`` (the
    library's yardstick, which the port never calls) at ``LN_CASES``: per
    launch (the wrapper and its enqueue) and device time of 8 queued, the
    queued runs cycling through copies of the inputs larger together than
    the L2, with the bound from bytes; untimed at 1 and 3 rows and at edge
    rows of every width. The residual sum bit-equal, each output within
    ``LN_MAX_ULPS`` bf16 steps, the share of flipped outputs; at rows whose
    statistics are exact (``ln_exact_inputs``, 8 x 1504 of every width) the
    outputs bit-equal. Then one batch
    of WavLM-Large (8 x 3 s) and of XLS-R 2B (2 x 20 s), bf16 with seeded
    weights, through ``encode``: the launches, 2 a layer with the final norm
    and the feature projection's (50 and 98), and the pooled rows against
    the same batch with the gate closed. Returns (worst ulps, the numbers of
    the fused form at XLS-R's 30 s bucket, every timed case's numbers)."""
    import math

    import torch.nn.functional as F

    from stutter_tpu_torch.ops import layer_norm as ln
    from stutter_tpu_torch.utils.benchmarking import BF16_PEAK, bound

    g = torch.Generator(device="cuda").manual_seed(24)
    eps = 1e-5
    params = {D: ((1.0 + 0.1 * torch.randn(D, device="cuda", generator=g)).to(torch.bfloat16),
                  (0.02 * torch.randn(D, device="cuda", generator=g)).to(torch.bfloat16))
              for D in ln.WIDTHS}
    cases = ([(B, L, D, "timed") for B, L, D in LN_CASES]
             + [(1, rows, D, "edges") for D in ln.WIDTHS for rows in (1, 3)]
             + [(4, 37, D, "edges") for D in ln.WIDTHS]
             + [(8, 1504, D, "exact") for D in ln.WIDTHS])
    worst, numbers = 0, {}
    for B, L, D, kind in cases:
        timed = kind == "timed"
        if kind == "exact":
            x, delta = ln_exact_inputs(torch, B, L, D, g)
        else:
            x, delta = ln_inputs(torch, B, L, D, g, edges=not timed)
        scale, bias = params[D]
        for fused in (False, True):
            d = delta if fused else None
            form = "fused" if fused else "norm"
            before = ln.add_layer_norm.launches, ln.add_layer_norm.launches_fused
            s, out = ln.add_layer_norm(x, d, scale, bias, eps)
            check((ln.add_layer_norm.launches, ln.add_layer_norm.launches_fused)
                  == (before[0] + 1, before[1] + fused),
                  f"layer_norm {B}x{L}x{D} {form}: the wrapper counted "
                  f"{ln.add_layer_norm.launches - before[0]} launches")
            s_ref, ref = ln.add_layer_norm_reference(x, d, scale, bias, eps)
            lib = F.layer_norm(s_ref, (D,), scale, bias, eps)
            torch.cuda.synchronize()
            check(out.shape == x.shape and out.dtype == torch.bfloat16
                  and bool(torch.isfinite(out).all()),
                  f"layer_norm output {out.dtype} {tuple(out.shape)} or non-finite")
            check(torch.equal(s, s_ref), f"layer_norm {B}x{L}x{D}: the residual sum differs")
            ulps, diff = bf16_ulps(torch, out, ref), (out.float() - ref.float()).abs()
            steps = ulps > LN_MAX_ULPS  # more than a step: only where the bias cancels
            max_ulps, steps_abs = int(ulps.max()), float(diff[steps].max()) if bool(
                steps.any()) else 0.0
            share, max_abs = float((ulps > 0).sum()) / ulps.numel(), float(diff.max())
            lib_max_abs = float((lib.float() - ref.float()).abs().max())
            fields = dict(shape=f"{B}x{L}x{D}", rows=kind, form=form, max_abs_err=f"{max_abs:.3e}",
                          max_ulps=max_ulps, ulps_tol=LN_MAX_ULPS,
                          multi_step_max_abs=f"{steps_abs:.2e}",
                          multi_step_tol=f"{LN_NEAR_ZERO_ABS:.2e}", flipped_share=f"{share:.2e}",
                          share_tol=LN_FLIP_SHARE, library_vs_plain_max_abs=f"{lib_max_abs:.3e}")
            if timed:
                def library(x, d):
                    return F.layer_norm(x if d is None else x + d, (D,), scale, bias, eps)

                def kernel(x, d):
                    return ln.add_layer_norm(x, d, scale, bias, eps)

                def plain(x, d):
                    return ln.add_layer_norm_reference(x, d, scale, bias, eps)

                ms, plain_ms, library_ms = time_turns(
                    torch, lambda: kernel(x, d), lambda: plain(x, d), lambda: library(x, d))
                nbytes = (8 if fused else 4) * x.numel() + 2 * scale.numel() * 2
                copies = [(x.clone(), None if d is None else d.clone())
                          for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)))]
                queued_ms, library_queued_ms = device_turns(
                    torch, cycling(kernel, copies), cycling(library, copies))
                bound_ms, bound_by = bound(0, nbytes, BF16_PEAK)  # ~10 f32 operations an element
                fields.update(ms=f"{ms:.4f}", queued_ms=f"{queued_ms:.4f}",
                              plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
                              library_queued_ms=f"{library_queued_ms:.4f}",
                              bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                              roofline_pct=f"{100 * bound_ms / queued_ms:.1f}",
                              input_copies=len(copies), card=f'"{card}"')
                numbers[f"{B}x{L}x{D}_{form}"] = dict(
                    timing(ms, plain_ms, bound_ms, bound_by, library_ms), queued_ms=queued_ms,
                    library_queued_ms=library_queued_ms, max_ulps=max_ulps, flipped_share=share)
                del copies
            say("layer_norm", **fields)
            check(steps_abs <= LN_NEAR_ZERO_ABS and share <= LN_FLIP_SHARE,
                  f"layer_norm {B}x{L}x{D} {form}: {max_ulps} bf16 steps from the plain "
                  f"version ({steps_abs:.2e} where more than {LN_MAX_ULPS}), {share:.2e} of "
                  "the outputs flipped")
            check(kind != "exact" or max_ulps == 0,
                  f"layer_norm {B}x{L}x{D} {form}: {share:.2e} of the outputs flipped on rows "
                  "whose statistics are exact")
            worst = max(worst, max_ulps)
            del s, out, s_ref, ref, lib, ulps, diff, steps
        del x, delta
        torch.cuda.empty_cache()
    for family in ("wavlm", "wav2vec2"):
        layer_norm_model_batch(torch, family)
        torch.cuda.empty_cache()
    return worst, numbers["8x1504x1920_fused"], numbers


def layer_norm_model_batch(torch, family: str) -> None:
    """One bf16 batch with seeded weights through ``encode``: WavLM-Large at
    8 x 3 s or XLS-R 2B at 2 x 20 s, frame-aligned (the fused stem writes
    the projection's frames). The launches: 2 a layer (the first norm, then
    the add and the second norm, fused), the final norm and the projection's;
    the pooled rows against the same batch with the gate closed."""
    import math

    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
    from stutter_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model
    from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
    from stutter_tpu_torch.ops import layer_norm as ln

    if family == "wavlm":
        cfg, B, L = WavLMConfig.large(), 8, 160
        model = WavLMModel(cfg, device="cuda", dtype=torch.bfloat16)
    else:
        cfg, B, L = Wav2Vec2Config.xls_r_2b(), 2, 1008
        model = Wav2Vec2Model(cfg, device="cuda", dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(25)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:  # dense [out, in], conv [out, in, k]
                p.normal_(0.0, math.prod(p.shape[1:]) ** -0.5, generator=g)
            elif name.endswith(("_s", "ln_scale", "norm_scale", "gru_const")):
                p.normal_(1.0, 0.1, generator=g)
            else:
                p.normal_(0.0, 0.02, generator=g)
    T = L * 320 + 80
    lengths = torch.tensor([T] + [T * 2 // 3] * (B - 1), device="cuda")
    wave = torch.randn(B, T, device="cuda", generator=g) * 0.1
    wave[1:, T * 2 // 3:] = 0.0
    wave = wavlm_prepare_batch(wave, lengths, cfg.do_normalize)
    layers = tuple(range(0, cfg.num_hidden_layers + 1, 4))
    zero_counts()
    rows = model.encode(wave, layers, lengths)
    torch.cuda.synchronize()
    counts = read_counts()
    n = cfg.num_hidden_layers
    check(counts["wavlm_fused_stem"] == 1, f"layer_norm {family}: the fused stem did not run")
    check((counts["layer_norm"], counts["layer_norm_fused"]) == (2 * n + 2, n),
          f"layer_norm {family}: {counts['layer_norm']} launches, {counts['layer_norm_fused']} "
          f"fused, expected {2 * n + 2} and {n}")
    real = ln._on_card
    ln._on_card = lambda t: False
    try:
        plain = model.encode(wave, layers, lengths)
        torch.cuda.synchronize()
    finally:
        ln._on_card = real
    check(read_counts()["layer_norm"] == 2 * n + 2, "the closed gate launched the kernel")
    worst = worst_pooled(rows.float(), plain.float())
    say("layer_norm", model=family, batch=f"{B}x{L}", launches=counts["layer_norm"],
        fused=counts["layer_norm_fused"], expected=f"{2 * n + 2},{n}",
        pooled_cosine_vs_gate_closed=f"{worst:.3e}", tol=LN_POOLED_COSINE)
    check(worst <= LN_POOLED_COSINE,
          f"layer_norm {family}: pooled rows {worst:.3e} from the gate-closed batch")
    del model, rows, plain, wave


def worst_pooled(a, b) -> float:
    """Worst cosine distance over the [S, B, D] pooled embeddings."""
    return max(cosine_distance(a[s, i], b[s, i])
               for s in range(a.shape[0]) for i in range(a.shape[1]))


def phase_turbo_fidelity(torch, name: str, embed, turbo_model, fast_model, fid_model,
                         preset: str = "turbo"):
    """One batch through the turbo (or turbo_ffn), fast and f32 models
    (``embed(model)`` gives pooled [S, B, D]): turbo's worst pooled cosine
    distance from f32 (bar 2e-2, the JAX turbo tests'), fast's beside it."""
    from stutter_tpu_torch.ops.precision import no_tf32

    with no_tf32():
        ref = embed(fid_model)
    turbo, fast = embed(turbo_model), embed(fast_model)
    check(bool(torch.isfinite(turbo).all()), f"{name} turbo: non-finite pooled embeddings")
    d_turbo, d_fast = worst_pooled(turbo, ref), worst_pooled(fast, ref)
    say("turbo_fidelity", model=name, preset=preset, batch=f"{turbo.shape[1]}",
        turbo_cosine_vs_f32=f"{d_turbo:.3e}", fast_cosine_vs_f32=f"{d_fast:.3e}",
        bar=TURBO_COSINE)
    check(d_turbo <= TURBO_COSINE, f"{name} {preset} {d_turbo:.3e} from f32, bar {TURBO_COSINE}")


# --- checkpoints, the chunk policy and serving --------------------------------

# the pooled rows of another batching of the same clips in bf16: the repo's bar
CHUNK_COSINE = 1e-3
# a FLAC body holding a WAV body's samples: one clip of the same bucket, so
# the same batch shape and the same row
FLAC_POST_COSINE = 1e-6


def write_safetensors(path: Path, tensors: dict) -> None:
    """The safetensors format by hand, float32 only (a GPU host may lack the
    package): 8 bytes of little-endian header length, the JSON
    header (dtype, shape, data_offsets), then each tensor's bytes."""
    header, offset, arrays = {}, 0, []
    for name, t in tensors.items():
        a = t.detach().cpu().float().contiguous().numpy()
        header[name] = {"dtype": "F32", "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
        arrays.append(a)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for a in arrays:
            a.tofile(f)


def fold_pos_conv(model) -> tuple:
    """(g, v) of a weight-normed positional conv whose v is the model's
    weight; the model's weight becomes g * v / ||v|| (norm over dims 0, 1,
    in float64), the fold an HF checkpoint's loader computes."""
    import numpy as np
    import torch

    v = model.pos_conv.weight.detach().cpu().numpy().copy()
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True))
    g = norm.astype(np.float32)
    with torch.no_grad():
        model.pos_conv.weight.copy_(torch.from_numpy((g * v / norm).astype(np.float32)))
    return torch.from_numpy(g), torch.from_numpy(v)


def wavlm_hf_state(model, g, v, weight_g_v: bool) -> dict:
    """A WavLMModel's weights under HF ``WavLMModel`` names, the positional
    conv as (g, v) in either torch weight-norm naming."""
    sd, cfg = model.state_dict(), model.cfg
    out = {"masked_spec_embed": sd["masked_spec_embed"]}
    for i in range(len(cfg.conv_dim)):
        p, q = f"feature_extractor.conv_layers.{i}", f"feature_encoder.layers.{i}"
        for hf, ours in (("conv.weight", "weight"), ("conv.bias", "bias"),
                         ("layer_norm.weight", "norm_scale"), ("layer_norm.bias", "norm_bias")):
            if f"{q}.{ours}" in sd:
                out[f"{p}.{hf}"] = sd[f"{q}.{ours}"]
    for hf, ours in (("feature_projection.layer_norm.weight", "feature_projection.ln_scale"),
                     ("feature_projection.layer_norm.bias", "feature_projection.ln_bias"),
                     ("feature_projection.projection.weight", "feature_projection.weight"),
                     ("feature_projection.projection.bias", "feature_projection.bias"),
                     ("encoder.pos_conv_embed.conv.bias", "pos_conv.bias"),
                     ("encoder.layer_norm.weight", "ln_scale"),
                     ("encoder.layer_norm.bias", "ln_bias"),
                     ("encoder.layers.0.attention.rel_attn_embed.weight", "rel_attn_embed")):
        out[hf] = sd[ours]
    names = ("weight_g", "weight_v") if weight_g_v else (
        "parametrizations.weight.original0", "parametrizations.weight.original1")
    out[f"encoder.pos_conv_embed.conv.{names[0]}"] = g
    out[f"encoder.pos_conv_embed.conv.{names[1]}"] = v
    layer = {"attention.q_proj": "attention.q", "attention.k_proj": "attention.k",
             "attention.v_proj": "attention.v", "attention.out_proj": "attention.o",
             "attention.gru_rel_pos_linear": "attention.gru",
             "feed_forward.intermediate_dense": "feed_forward.?1",
             "feed_forward.output_dense": "feed_forward.?2"}
    for i in range(cfg.num_hidden_layers):
        p, q = f"encoder.layers.{i}", f"layers.{i}"
        for hf, ours in layer.items():
            w, b = (ours.replace("?", "w"), ours.replace("?", "b")) if "?" in ours else (
                ours + "_w", ours + "_b")
            out[f"{p}.{hf}.weight"], out[f"{p}.{hf}.bias"] = sd[f"{q}.{w}"], sd[f"{q}.{b}"]
        for hf, ours in (("layer_norm", "ln1"), ("final_layer_norm", "ln2")):
            out[f"{p}.{hf}.weight"], out[f"{p}.{hf}.bias"] = sd[f"{q}.{ours}_s"], sd[f"{q}.{ours}_b"]
        out[f"{p}.attention.gru_rel_pos_const"] = sd[f"{q}.attention.gru_const"].reshape(
            1, -1, 1, 1)
    return out


def whisper_hf_state(model) -> dict:
    """A WhisperModel's weights under HF ``WhisperModel`` names."""
    out = {}
    top = {"conv1_w": "conv1.weight", "conv1_b": "conv1.bias", "conv2_w": "conv2.weight",
           "conv2_b": "conv2.bias", "pos_embed": "embed_positions.weight",
           "embed_tokens": "embed_tokens.weight", "ln_s": "layer_norm.weight",
           "ln_b": "layer_norm.bias"}
    blocks = {"attn": "self_attn", "xattn": "encoder_attn"}
    leaf = {"w": "weight", "b": "bias", "s": "weight"}
    for name, t in model.state_dict().items():
        block, _, rest = name.partition(".")
        if not rest.startswith("layers."):
            out[f"{block}.{top[rest]}"] = t
            continue
        i, _, key = rest[len("layers."):].partition(".")
        if key.startswith(("attn.", "xattn.")):
            sub, _, pk = key.partition(".")
            proj, _, kind = pk.partition("_")
            hf = f"{blocks[sub]}.{'out' if proj == 'o' else proj}_proj.{leaf[kind]}"
        elif key.startswith("ffn."):
            fc, _, kind = key[4:].partition("_")
            hf = f"{fc}.{leaf[kind]}"
        else:
            norm, _, kind = key.partition("_")
            hf = {"ln1": "self_attn_layer_norm", "ln3": "final_layer_norm",
                  "ln2": "encoder_attn_layer_norm" if block == "decoder"
                  else "final_layer_norm"}[norm] + "." + leaf[kind]
        out[f"{block}.layers.{i}.{hf}"] = t
    return out


def hf_config(cfg) -> dict:
    """The config.json fields the loaders read, from a port config."""
    import dataclasses

    d = dataclasses.asdict(cfg)
    if "d_model" in d:
        return dict(d_model=cfg.d_model, encoder_layers=cfg.encoder_layers,
                    encoder_attention_heads=cfg.encoder_attention_heads,
                    decoder_layers=cfg.decoder_layers,
                    decoder_attention_heads=cfg.decoder_attention_heads,
                    encoder_ffn_dim=cfg.ffn_dim, decoder_ffn_dim=cfg.ffn_dim,
                    num_mel_bins=cfg.num_mel_bins, max_source_positions=cfg.max_source_positions,
                    max_target_positions=cfg.max_target_positions, vocab_size=cfg.vocab_size,
                    model_type="whisper")
    keys = ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
            "conv_dim", "conv_stride", "conv_kernel", "conv_bias", "feat_extract_norm",
            "do_stable_layer_norm", "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
            "num_buckets", "max_bucket_distance", "layer_norm_eps")
    return dict({k: d[k] for k in keys}, model_type="wavlm")


@contextlib.contextmanager
def without_safetensors():
    """Inside, importing the safetensors package fails, so the loader parses
    the files itself (the submodule too: an imported one is found without
    its parent)."""
    saved = {k: sys.modules.get(k) for k in ("safetensors", "safetensors.torch")}
    sys.modules.update(dict.fromkeys(saved))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def write_checkpoint(torch, path: Path, cfg, hf_state: dict, layout: str,
                     do_normalize: bool | None = None) -> float:
    """An HF checkpoint directory: config.json, the weights as one
    safetensors file or a pytorch_model.bin, and for WavLM the
    preprocessor_config.json. Returns the bytes written, in GB."""
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(hf_config(cfg)))
    if do_normalize is not None:
        (path / "preprocessor_config.json").write_text(json.dumps({"do_normalize": do_normalize}))
    if layout == "safetensors":
        write_safetensors(path / "model.safetensors", hf_state)
    else:
        torch.save({k: t.contiguous() for k, t in hf_state.items()}, path / "pytorch_model.bin")
    return sum(f.stat().st_size for f in path.iterdir()) / 1e9


def phase_checkpoint(torch, work: Path, card: str, device: str = "cuda",
                     whisper_layers: int = 4, seconds: float = 3.0,
                     names=("wavlm-large", "whisper-large")):
    """WavLM-Large (full depth) and Whisper-large widths at 4 + 4 layers,
    from the port's seeded init, written as HF checkpoint directories (a
    hand-written model.safetensors, read with and without the package, and
    a pytorch_model.bin with the weight_g/weight_v names), loaded by
    load_wavlm / load_whisper, checked by
    verify_* on the device: every tensor and one fast batch's pooled
    embeddings bit-equal to the seeded model's. Returns the loaded f32 WavLM."""
    import dataclasses

    import numpy as np

    from stutter_tpu_torch.extract.batcher import Batch
    from stutter_tpu_torch.extract.pipeline import WavLMExtractor, WhisperExtractor
    from stutter_tpu_torch.models.verify import verify_wavlm, verify_whisper
    from stutter_tpu_torch.models.wavlm import WavLMConfig
    from stutter_tpu_torch.models.whisper import WhisperConfig
    from stutter_tpu_torch.weights.convert import init_wavlm, init_whisper, load_wavlm, load_whisper

    rng = np.random.RandomState(11)
    loaded_wavlm = None
    for kind in ("wavlm", "whisper"):
        if kind == "wavlm":
            cfg = WavLMConfig.large()
            seeded = init_wavlm(cfg, torch.Generator().manual_seed(0))
            g, v = fold_pos_conv(seeded)
            states = {"safetensors": wavlm_hf_state(seeded, g, v, weight_g_v=False),
                      "bin": wavlm_hf_state(seeded, g, v, weight_g_v=True)}
            load, verify, make = load_wavlm, verify_wavlm, WavLMExtractor
            name, samples = names[0], int(seconds * 16000)
        else:
            cfg = dataclasses.replace(WhisperConfig.large(), encoder_layers=whisper_layers,
                                      decoder_layers=whisper_layers)
            seeded = init_whisper(cfg, torch.Generator().manual_seed(0))
            states = dict.fromkeys(("safetensors", "bin"), whisper_hf_state(seeded))
            load, verify, make = load_whisper, verify_whisper, WhisperExtractor
            name, samples = names[1], 480_000
        B = 8
        lengths = rng.randint(samples // 3, samples + 1, size=B)
        waves = np.zeros((B, samples), np.float32)
        for j, n in enumerate(lengths):
            waves[j, :n] = 0.1 * rng.randn(n)
        batch = Batch(paths=[""] * B, rows=list(range(B)), waves=waves,
                      lengths=lengths.astype(np.int64), ok=np.ones(B, bool), bucket_s=30.0)
        reference = make(copy.deepcopy(seeded), device, preset="fast")(batch)
        for layout in ("safetensors", "safetensors_by_hand", "bin"):
            path = work / f"ckpt_{kind}_{layout.removesuffix('_by_hand')}" / name
            write_s = 0.0
            if layout != "safetensors_by_hand":  # the same files, read without the package
                t0 = time.perf_counter()
                gb = write_checkpoint(torch, path, cfg, states[layout], layout,
                                      do_normalize=cfg.do_normalize if kind == "wavlm" else None)
                write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            with without_safetensors() if layout.endswith("by_hand") else contextlib.nullcontext():
                cfg_loaded, model = load(str(path))
            load_s = time.perf_counter() - t0
            check(cfg_loaded == cfg, f"{kind} {layout}: config {cfg_loaded} != {cfg}")
            sd, ref = model.state_dict(), seeded.state_dict()
            check(sorted(sd) == sorted(ref), f"{kind} {layout}: state dict keys differ")
            unequal = [k for k in ref if not torch.equal(sd[k], ref[k])]
            check(not unequal, f"{kind} {layout}: tensors differ from the seeded model's: "
                               f"{unequal[:5]}")
            t0 = time.perf_counter()
            model = model.to(device)
            states_n = verify(model, name)
            verify_s = time.perf_counter() - t0
            if kind == "wavlm" and loaded_wavlm is None:
                loaded_wavlm = copy.deepcopy(model).cpu()
            pooled = make(model, device, preset="fast")(batch)
            differ = [c for c in reference if not np.array_equal(pooled[c], reference[c])]
            check(not differ, f"{kind} {layout}: pooled embeddings differ in {differ}")
            say("checkpoint", model=kind, layout=layout, layers=states_n, gb=f"{gb:.3f}",
                write_s=f"{write_s:.2f}", load_s=f"{load_s:.2f}", verify_s=f"{verify_s:.2f}",
                tensors_bit_equal=len(ref), pooled_bit_equal=f"{B}x{len(reference)}",
                card=f'"{card}"')
            del model, pooled
        del seeded, reference
        if device == "cuda":
            torch.cuda.empty_cache()
    return loaded_wavlm


def phase_chunk(torch, extractor, work: Path, card: str, short=(3.0, 8.0), long=(41.0, 75.0),
                buckets=None) -> tuple:
    """ExtractionPipeline with long_files="chunk" over 8 clips of 3-8 s and 3
    of 41-75 s (train, test, devel): the long rows against
    chunked_embeddings of the same files (cosine <= 1e-3, another batching in
    bf16), the gated launches exactly 24 per submitted batch, the chunks
    column. Returns (launch counts, the store, its audio-s/s)."""
    import numpy as np

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, chunked_embeddings
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    on_card = extractor.device.type == "cuda"
    corpus, store = work / "chunk_corpus", work / "chunk_store"
    audio_s = write_corpus(corpus, {"train": 4, "test": 2, "devel": 2}, short, seed=21,
                           long_per_split={"train": 1, "test": 1, "devel": 1}, long_range=long)
    meta = create_metadata_from_files(str(corpus))

    def batcher():
        return BucketBatcher(frame_align=extractor.frame_align,
                             **({"buckets_s": buckets} if buckets else {}))

    pipe = ExtractionPipeline(extractor, batcher=batcher(), long_file_policy="chunk")
    seen = count_submits(extractor)
    zero_counts()
    t0 = time.perf_counter()
    results = pipe.run(meta, str(store / "wavlm"))
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del extractor.submit
    n_layers = extractor.cfg.num_hidden_layers
    launches = counts["gated_relpos_attention"]
    check(launches == n_layers * seen["batches"] * on_card,
          f"chunk: gated attention launched {launches} times for {seen['batches']} batches")
    check_wavlm_kernels("chunk", counts, seen["batches"], on_card, n_layers)
    rows = [r for split in results.values() for r in split]
    long_rows = [r for r in rows if "chunks" in r]
    check(len(rows) == 11 and len(long_rows) == 3,
          f"chunk: {len(rows)} rows, {len(long_rows)} chunked, expected 11 and 3")
    worst = 0.0
    for r in long_rows:
        ref, n_chunks, _ = chunked_embeddings(extractor, batcher(), r["path"])
        check(n_chunks == r["chunks"], f"chunk: {r['path']} {r['chunks']} vs {n_chunks} chunks")
        worst = max([worst] + [cosine_distance(torch.from_numpy(r[c]), torch.from_numpy(ref[c]))
                               for c in extractor.column_names])
    check(worst <= CHUNK_COSINE, f"chunk: long rows {worst:.3g} from chunked_embeddings")
    check(all(bool(np.isfinite(r[c]).all()) for r in rows for c in extractor.column_names),
          "chunk: non-finite rows")
    rate = audio_s / wall
    say("chunk", clips=len(rows), chunked=len(long_rows),
        chunks=",".join(str(int(r["chunks"])) for r in long_rows), audio_s=f"{audio_s:.1f}",
        batches=seen["batches"], launches=launches, expected=f"{n_layers}x{seen['batches']}",
        worst_cosine_vs_single_file=f"{worst:.3g}", wall_s=f"{wall:.2f}",
        audio_s_per_s=f"{rate:.1f}", card=f'"{card}"')
    return counts, store, rate


def fit_serving_head(store: Path, work: Path, device: str, n_layers: int) -> Path:
    """The served classifier: an MLP head run_balanced_training fits on the
    store's top layer (20 epochs), under work/serve_head. Returns its file."""
    from stutter_tpu_torch.train.trainer import TrainConfig, run_balanced_training

    results = work / "serve_head"
    best = run_balanced_training(TrainConfig(
        embeddings_dir=str(store), results_dir=str(results), classifiers=("mlp",),
        use_smote=False, make_plots=False, head_overrides={"epochs": 20}, device=device))
    layer = f"layer_{n_layers}"
    model_path = results / layer / f"wavlm_{layer}_mlp_model.npz"
    check(layer in best and model_path.is_file(), f"serve: no head written at {model_path}")
    return model_path


def phase_serve(torch, extractor, store: Path, work: Path, card: str, durations=(1.0, 8.0),
                long_s=41.0, buckets=None, http_posts: int = 8) -> dict:
    """EmbeddingServer over the loaded WavLM (max_clips 64, max_wait 0.1 s,
    chunk policy) with a ServingClassifier from an MLP head that
    run_balanced_training fits on the [chunk] store: 96 JSONL requests (93
    clips of 1-8 s, two of 41 s, one undecodable file), then POSTs to the
    HTTP frontend on 127.0.0.1:0 (JSON paths and raw WAV bytes), /stats and
    /healthz. Checks: each request answered once, only the bad file fails,
    every embedding within 1e-3 cosine of the file's ExtractionPipeline row,
    the predictions equal load_model(...).predict, 24 gated launches per
    batch. Returns the launch counts of the JSONL run."""
    import io
    import urllib.request

    import numpy as np

    from stutter_tpu_torch.audio.build import get_ff_lib
    from stutter_tpu_torch.audio.wavio import encode_audio, read_wav
    from stutter_tpu_torch.cli.common import make_bucket_batcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.serve.classify import ServingClassifier
    from stutter_tpu_torch.serve.http import HttpEmbeddingFrontend
    from stutter_tpu_torch.serve.server import EmbeddingServer, jsonl_requests
    from stutter_tpu_torch.train.persistence import load_model

    on_card = extractor.device.type == "cuda"
    device = str(extractor.device)
    n_layers = extractor.cfg.num_hidden_layers
    t0 = time.perf_counter()
    model_path = fit_serving_head(store, work, device, n_layers)
    fit_s = time.perf_counter() - t0
    clf = ServingClassifier.load(str(model_path), device=device)

    corpus = work / "serve_corpus"
    audio_s = write_corpus(corpus, {"train": 93}, durations, seed=31,
                           long_per_split={"train": 2}, long_range=(long_s, long_s + 0.5))
    paths = sorted(str(p) for p in (corpus / "wav").glob("*.wav"))
    bad = corpus / "undecodable.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    lines = [json.dumps({"id": f"q{i:03d}", "path": p}) for i, p in enumerate(paths)]
    lines.insert(50, json.dumps({"id": "bad", "path": str(bad)}))

    def batcher():
        return make_bucket_batcher(extractor, None, buckets_s=buckets, audio_budget_s=64 * 3.0,
                                   max_batch=64)

    # every file's row from the pipeline, the reference for the served vectors
    rows = ExtractionPipeline(extractor, batcher=batcher(), long_file_policy="chunk").run(
        create_metadata_from_files(str(corpus)), str(work / "serve_store"), splits=("train",))
    by_path = {r["path"]: r for r in rows["train"]}

    server = EmbeddingServer(extractor, batcher=batcher(), max_wait_s=0.1, max_clips=64,
                             long_clip_policy="chunk", classifier=clf)
    responses = []
    seen = count_submits(extractor)
    zero_counts()
    t0 = time.perf_counter()
    server.serve(jsonl_requests(io.StringIO("\n".join(lines) + "\n")), responses.append)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    del extractor.submit
    stats = server.stats()
    launches = counts["gated_relpos_attention"]
    ids = [r.req_id for r in responses]
    check(sorted(ids) == sorted([f"q{i:03d}" for i in range(len(paths))] + ["bad"]),
          f"serve: {len(ids)} answers, {len(set(ids))} distinct, for {len(lines)} requests")
    failed = [r.req_id for r in responses if not r.ok]
    check(failed == ["bad"], f"serve: failed requests {failed}, expected only 'bad'")
    check(launches == n_layers * seen["batches"] * on_card,
          f"serve: gated attention launched {launches} times for {seen['batches']} batches")
    check_wavlm_kernels("serve", counts, seen["batches"], on_card, n_layers)
    served = [r for r in responses if r.ok]
    worst = max(cosine_distance(torch.from_numpy(r.embeddings[c]),
                                torch.from_numpy(by_path[r.path][c]))
                for r in served for c in extractor.column_names)
    check(worst <= CHUNK_COSINE, f"serve: served rows {worst:.3g} from the pipeline's")
    X = np.stack([r.embeddings[clf.layer] for r in served])
    expect = [clf.class_names[int(i)] for i in load_model(str(model_path), device=device).predict(X)]
    check([r.prediction for r in served] == expect, "serve: predictions differ from load_model's")
    check(all(r.error is None for r in served), "serve: a classification failed")
    check(stats["device_s_per_audio_s"] > 0 or not on_card, f"serve: stats {stats}")
    say("serve", requests=len(lines), answered=len(ids), failed=",".join(failed),
        rounds=stats["rounds"], batches=seen["batches"], launches=launches,
        expected=f"{n_layers}x{seen['batches']}", worst_cosine_vs_pipeline=f"{worst:.3g}",
        head_fit_s=f"{fit_s:.2f}", card=f'"{card}"')
    say("serve", p50_ms=f"{stats['p50_s'] * 1e3:.1f}", p95_ms=f"{stats['p95_s'] * 1e3:.1f}",
        pr11_p50_p95_ms=PR11_SERVE_P50_P95_MS, max_ms=f"{stats['max_s'] * 1e3:.1f}",
        device_s_per_audio_s=stats["device_s_per_audio_s"], audio_s=f"{audio_s:.1f}",
        wall_s=f"{wall:.2f}", audio_s_per_s=f"{audio_s / wall:.1f}", card=f'"{card}"')

    # the HTTP frontend over the same server
    frontend = HttpEmbeddingFrontend(server, host="127.0.0.1", port=0, request_timeout_s=120)
    frontend.start()
    http_answers = []
    try:
        base = f"http://{frontend.host}:{frontend.port}"
        for i, path in enumerate(paths[:http_posts]):
            if i % 2:
                body, ctype = Path(path).read_bytes(), "audio/wav"
            else:
                body, ctype = json.dumps({"path": path}).encode(), "application/json"
            req = urllib.request.Request(base + "/embed", data=body, method="POST",
                                         headers={"Content-Type": ctype})
            with urllib.request.urlopen(req, timeout=120) as r:
                obj = json.loads(r.read())
                http_answers.append((r.status, path, obj))
        flac_answer = None
        if get_ff_lib() is not None:  # paths[1] went up as WAV bytes above
            x, sr = read_wav(paths[1])
            flac = work / "serve_post.flac"
            encode_audio(str(flac), x * np.float32(32768 / 32767), sr)  # the same samples
            req = urllib.request.Request(base + "/embed", data=flac.read_bytes(), method="POST",
                                         headers={"Content-Type": "audio/flac"})
            with urllib.request.urlopen(req, timeout=120) as r:
                flac_answer = (r.status, json.loads(r.read()))
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            health = (r.status, json.loads(r.read()))
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            http_stats = json.loads(r.read())
    finally:
        frontend.shutdown()
    check(health == (200, {"ok": True}), f"serve: /healthz answered {health}")
    check(http_stats["served"] >= len(served) + http_posts, f"serve: /stats {http_stats}")
    http_worst = 0.0
    for status, path, obj in http_answers:
        check(status == 200 and obj["ok"] and obj.get("prediction") in clf.class_names,
              f"serve: HTTP answer {status} {obj.get('error')} for {path}")
        http_worst = max([http_worst] + [
            cosine_distance(torch.tensor(obj["embeddings"][c]), torch.from_numpy(by_path[path][c]))
            for c in extractor.column_names])
    check(http_worst <= CHUNK_COSINE, f"serve: HTTP rows {http_worst:.3g} from the pipeline's")
    flac_fields = {"flac_post": '"no libav headers"'}
    if flac_answer is not None:
        status, obj = flac_answer
        wav_obj = http_answers[1][2]
        check(status == 200 and obj["ok"], f"serve: the FLAC POST got {status} {obj.get('error')}")
        flac_worst = max(cosine_distance(torch.tensor(obj["embeddings"][c]),
                                         torch.tensor(wav_obj["embeddings"][c]))
                         for c in extractor.column_names)
        check(flac_worst <= FLAC_POST_COSINE,
              f"serve: the FLAC POST's rows {flac_worst:.3g} from the WAV POST's")
        flac_fields = {"flac_post": status, "flac_vs_wav_cosine": f"{flac_worst:.3g}"}
    say("serve_http", posts=len(http_answers), worst_cosine_vs_pipeline=f"{http_worst:.3g}",
        healthz=health[0], stats_served=http_stats["served"], **flac_fields, card=f'"{card}"')
    return dict(counts, batches=seen["batches"], stats=stats, audio_s_per_s=audio_s / wall,
                head=model_path)


# ---------------------------------------------------------------------------
# [parallel]: the port's process groups on the card
# ---------------------------------------------------------------------------

# two ranks' pooled rows (tensor-parallel cuts, data-parallel rows) against
# the one-process run: the kernel-vs-plain bar on the card (Whisper's fast
# decoder columns: WHISPER_FAST_DECODER_COSINE, as for any change of its
# encoder input)
PARALLEL_POOLED_COSINE = 1e-4
# the tensor-parallel batches (clips, samples, bucket seconds): WavLM-Large
# at L = 160 and 1504, Whisper-large at 30 s; the data-parallel corpus
# (clips, seconds, bucket seconds, audio seconds a batch: two batches of 32)
PARALLEL_SIZES = {"wavlm_3s": (16, 51_280, 3.0), "wavlm_30s": (2, 481_280, 30.0),
                  "whisper_30s": (4, 480_000, 30.0), "dp": (64, (2.0, 3.0), 3.0, 96.0)}
# data-parallel scaling over NCCL (two cards or more): [throughput]'s corpus,
# 1280 clips of 2-3 s in batches of 128 (64 a rank at two), run this many
# times on one card and on two
SCALING_CLIPS = 1280
SCALING_RUNS = 3
# tensor parallelism's time over NCCL: timed calls of each warm batch
TP_TIMED_CALLS = 5


def parallel_inputs(work: Path, sizes: dict) -> dict:
    """The tensor-parallel batches as host arrays (waves, lengths), ragged,
    from a seed, written once to work/parallel_batches.npz."""
    import numpy as np

    path = work / "parallel_batches.npz"
    names = ("wavlm_3s", "wavlm_30s", "whisper_30s")
    if not path.exists():
        rng = np.random.RandomState(21)
        out = {}
        for name in names:
            B, T, _ = sizes[name]
            lengths = rng.randint(T // 6, T + 1, size=B)
            lengths[0] = T
            t = np.arange(T) / 16000
            tone = np.sin(2 * np.pi * rng.uniform(100, 600, (B, 1)) * t[None])
            waves = (0.1 * rng.randn(B, T) + 0.2 * tone).astype(np.float32)
            waves *= np.arange(T)[None] < lengths[:, None]
            out[f"{name}_waves"], out[f"{name}_lengths"] = waves, lengths.astype(np.int64)
        np.savez(path, **out)
    z = np.load(path)
    return {name: (z[f"{name}_waves"], z[f"{name}_lengths"]) for name in names}


def host_batch(waves, lengths, bucket_s: float):
    import numpy as np

    from stutter_tpu_torch.extract.batcher import Batch

    n = len(waves)
    return Batch(paths=[f"clip{i}" for i in range(n)], rows=list(range(n)), waves=waves,
                 lengths=lengths, ok=np.ones(n, bool), bucket_s=bucket_s)


def load_fast(torch, work: Path, kind: str, device: str):
    """The fast (bf16) WavLM-Large or Whisper-large the earlier phases ran,
    from the state dict they left in ``work``."""
    from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
    from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel

    cls, cfg = ((WavLMModel, WavLMConfig.large()) if kind == "wavlm"
                else (WhisperModel, WhisperConfig.large()))
    model = cls(cfg, device="meta", dtype=torch.bfloat16).to_empty(device=device)
    model.load_state_dict(torch.load(work / f"{kind}_fast.pt", map_location=device, mmap=True))
    return model


def head_recorder(fn, seen: list):
    """An attention function that records the heads, the length and the
    bias plane (shape, contiguous) of each call it passes on to ``fn`` (the
    kernel wrapper, which counts its launches)."""

    def attention(q, k, v, *rest):
        plane = [(list(r.shape), r.is_contiguous()) for r in rest[:1]]
        seen.append([q.shape[1], q.shape[2], *plane])
        return fn(q, k, v, *rest)

    return attention


def dp_batcher(frame_align, sizes: dict):
    from stutter_tpu_torch.extract.batcher import BucketBatcher

    _, _, bucket_s, budget = sizes["dp"]
    return BucketBatcher(buckets_s=(bucket_s,), audio_budget_s=budget, batch_multiple=2,
                         frame_align=frame_align)


def scaling_batcher(frame_align):
    from stutter_tpu_torch.extract.batcher import BucketBatcher

    return BucketBatcher(buckets_s=(3.0,), batch_multiple=2, frame_align=frame_align)


def sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def batch_ms(torch, ex, batch) -> dict:
    """Wall ms of each of TP_TIMED_CALLS calls of an extractor on a warm
    batch on the card (each returns its pooled rows on the host), the ms
    the host took to enqueue each, and one more call under torch.profiler:
    its kernels' summed device ms (as the profiler's table sums them), the
    NCCL kernels' share (which includes a ring's wait for the other rank)
    and the top kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {"ms": [], "enqueue_ms": []}
    for _ in range(TP_TIMED_CALLS):
        t0 = time.perf_counter()
        handle = ex.submit(batch)
        t1 = time.perf_counter()
        ex.collect(handle)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["enqueue_ms"].append((t1 - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ex(batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    out["device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
    out["nccl_device_ms"] = sum(e.self_device_time_total for e in kernels
                                if e.key.startswith("ncclDevKernel")) / 1e3
    out["top"] = events.table(sort_by="self_device_time_total", row_limit=8)
    return out


def all_reduce_ms(torch, rows: int, width: int, group) -> list:
    """Wall ms of each of TP_TIMED_CALLS NCCL all-reduces of one block's
    row-parallel output, [rows, width] f32, over the model group."""
    import torch.distributed as dist

    x = torch.ones(rows, width, device="cuda")
    dist.all_reduce(x, group=group)  # the communicator is up already; a warm call
    out = []
    for _ in range(TP_TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def median(xs) -> float:
    import numpy as np

    return float(np.median(xs))


def parallel_rank(work: str, tag: str, device: str, sizes: dict) -> None:
    """One of two ranks (spawned by ``launch``): WavLM-Large at [1, 2] on
    the 3 s and 30 s batches and Whisper-large at [1, 2] on the 30 s batch,
    each rank's attention through the kernel at its local head count; then
    a [2, 1] data-parallel extraction of the DP corpus. Rank 0 writes the
    pooled rows, every rank its launch counts, heads and wall time. Over
    NCCL (``tag`` "nccl", one card a rank) it also times the tensor-parallel
    batches and runs the scaling corpus SCALING_RUNS times."""
    import json

    import numpy as np
    import torch

    from stutter_tpu_torch.extract.pipeline import (
        ExtractionPipeline,
        WavLMExtractor,
        WhisperExtractor,
    )
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.models import whisper as whisper_module
    from stutter_tpu_torch.ops.wavlm_attention import gated_relpos_attention
    from stutter_tpu_torch.parallel.mesh import make_plan

    work = Path(work)
    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    tp, dp = make_plan(data=1, model=2), make_plan(data=2)
    inputs = parallel_inputs(work, sizes)
    report = {"device": device}
    rows = {}
    over_nccl = tag == "nccl"
    ex = WavLMExtractor(load_fast(torch, work, "wavlm", device), device, preset="fast", plan=tp)
    attention_fn = ex.attention_fn
    for name in ("wavlm_3s", "wavlm_30s"):
        seen = []
        ex.attention_fn = head_recorder(gated_relpos_attention, seen)
        batch = host_batch(*inputs[name], sizes[name][2])
        zero_counts()
        pooled = ex(batch)
        report[name] = {"counts": read_counts(), "calls": seen}
        rows.update({f"{name}/{c}": a for c, a in pooled.items()})
        ex.attention_fn = attention_fn
        if over_nccl:
            report[name]["timing"] = batch_ms(torch, ex, batch)
            report[name]["all_reduce_ms"] = all_reduce_ms(
                torch, len(batch.waves) * seen[0][1], 1024, tp.model_group)
            report[name]["all_reduce_bytes"] = len(batch.waves) * seen[0][1] * 1024 * 4
    del ex
    ex = WhisperExtractor(load_fast(torch, work, "whisper", device), device, preset="fast",
                          plan=tp)
    seen, mha_self = [], whisper_module.mha_self
    whisper_module.mha_self = head_recorder(mha_self, seen)
    batch = host_batch(*inputs["whisper_30s"], sizes["whisper_30s"][2])
    try:
        zero_counts()
        pooled = ex(batch)
    finally:
        whisper_module.mha_self = mha_self
    report["whisper_30s"] = {"counts": read_counts(), "calls": seen}
    if over_nccl:
        report["whisper_30s"]["timing"] = batch_ms(torch, ex, batch)
        report["whisper_30s"]["all_reduce_ms"] = all_reduce_ms(
            torch, len(batch.waves) * seen[0][1], 1280, tp.model_group)
        report["whisper_30s"]["all_reduce_bytes"] = len(batch.waves) * seen[0][1] * 1280 * 4
    rows.update({f"whisper_30s/{c}": a for c, a in pooled.items()})
    del ex
    if device != "cpu":
        torch.cuda.empty_cache()

    ex = WavLMExtractor(load_fast(torch, work, "wavlm", device), device, preset="fast", plan=dp)
    batcher = dp_batcher(ex.frame_align, sizes)
    ex.warmup(batcher)
    meta = create_metadata_from_files(str(work / "dp_corpus"))
    zero_counts()
    t0 = time.perf_counter()
    ExtractionPipeline(ex, batcher=batcher, checkpoint_interval=10_000).run(
        meta, str(work / f"dp_store_{tag}"), splits=("train",))
    sync(torch, "cpu" if device == "cpu" else "cuda")
    report["dp"] = {"counts": read_counts(), "wall_s": time.perf_counter() - t0}
    if over_nccl:  # the scaling corpus, after a warm batch of its shape
        batcher = scaling_batcher(ex.frame_align)
        ex.warmup(batcher)
        meta = create_metadata_from_files(str(work / "timing_corpus"))
        report["scaling_wall_s"] = scaling_walls(torch, ex, batcher, meta, work, "nccl")
    if tp.rank == 0:
        np.savez(work / f"parallel_rows_{tag}.npz", **rows)
    (work / f"parallel_{tag}_rank{tp.rank}.json").write_text(json.dumps(report))


def scaling_walls(torch, ex, batcher, meta, work: Path, tag: str) -> list:
    """Wall seconds of SCALING_RUNS extractions of the scaling corpus, each
    into a store of its own (a store that exists would be resumed)."""
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline

    walls = []
    for run in range(SCALING_RUNS):
        t0 = time.perf_counter()
        ExtractionPipeline(ex, batcher=batcher, checkpoint_interval=10_000).run(
            meta, str(work / f"scaling_store_{tag}_{run}"), splits=("train",))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's and cuDNN's deterministic algorithms, for a bit-for-bit
    check of two training runs: without them the bucket table's index
    backward and cuDNN's convolution backward add with atomics, in an order
    that changes from run to run. cuBLAS gives the same bits on one active
    stream, as the trainers run, whatever its workspace; the workspace
    setting ``CUBLAS_WORKSPACE_CONFIG`` matters where several streams are
    active, and PyTorch's deterministic mode refuses cuBLAS without it. It
    is set for the block only: later phases and the ranks they spawn start
    without it."""
    workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    before = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]
        if workspace is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace


def parallel_world1(torch, work: Path, card: str, device: str, sizes: dict) -> None:
    """A one-rank group through ``make_plan`` (NCCL on the card): the [slice]
    corpus's rows bit-equal to [slice]'s store, audio-s/s with the group and
    without it in turns, and two data-parallel fine-tune steps of 8 x 3 s
    whose parameters equal the plain trainer's bit for bit (each step the
    summed path of one microbatch, its all-reduce over the group of one;
    both under ``deterministic``)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, WavLMExtractor
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.models.wavlm import WavLMConfig
    from stutter_tpu_torch.parallel.mesh import make_plan
    from stutter_tpu_torch.train.finetune import (
        FinetuneConfig,
        FinetuneTrainer,
        init_finetune_model,
    )

    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.FileStore(str(work / "world1.store"), 1),
                            rank=0, world_size=1)
    try:
        plan = make_plan(data=1, model=1)
        model = load_fast(torch, work, "wavlm", device)
        plain, grouped = (WavLMExtractor(model, device, preset="fast", plan=p)
                          for p in (None, plan))
        meta = create_metadata_from_files(str(work / "corpus"))
        audio_s = _CORPORA[work / "corpus"]
        walls = {"plain": [], "group": []}
        for turn, ex in enumerate((plain, grouped, grouped, plain)):
            pipe = ExtractionPipeline(ex, batcher=BucketBatcher(frame_align=ex.frame_align),
                                      checkpoint_interval=5)
            t0 = time.perf_counter()
            pipe.run(meta, str(work / f"world1_{turn}"))
            sync(torch, device)
            walls["plain" if ex is plain else "group"].append(time.perf_counter() - t0)
        for split in ("train", "test", "devel"):
            ref = work / "slice_store" / split
            for turn in range(4):
                d = work / f"world1_{turn}" / split
                check((d / "embedding_metadata.csv").read_bytes()
                      == (ref / "embedding_metadata.csv").read_bytes(),
                      f"world 1 {split}: the CSV differs from [slice]'s")
                for c in plain.column_names:
                    check(np.array_equal(np.load(d / f"{c}_embeddings.npy"),
                                         np.load(ref / f"{c}_embeddings.npy")),
                          f"world 1 run {turn} {split} {c}: rows differ from [slice]'s")
        rates = {k: audio_s / float(np.mean(v)) for k, v in walls.items()}
        say("parallel", step=f"{backend}_world1_extract", clips=len(meta),
            audio_s=f"{audio_s:.2f}", rows="bit-equal to [slice]",
            plain_audio_s_per_s=f"{rates['plain']:.1f}",
            group_audio_s_per_s=f"{rates['group']:.1f}",
            group_over_plain=f"{rates['group'] / rates['plain']:.3f}", card=f'"{card}"')
        del plain, grouped, model

        mcfg = dataclasses.replace(WavLMConfig.large(), apply_spec_augment=False)
        cfg = FinetuneConfig(model=mcfg, n_classes=4, head_dropout=0.0)
        state = init_finetune_model(cfg, device=device).state_dict()
        plain = FinetuneTrainer(cfg, device=device, params=state)
        grouped = FinetuneTrainer(cfg, device=device, params=state, plan=plan)
        del state
        rng = np.random.RandomState(5)
        cw = np.array([1.0, 2.0, 0.5, 1.5], np.float32)
        T = sizes["wavlm_3s"][1]
        losses = {"plain": [], "group": []}
        with deterministic(torch):
            for _ in range(2):
                lengths = rng.randint(T // 2, T + 1, size=8)
                waves = (rng.randn(8, T) * 0.1 * (np.arange(T)[None] < lengths[:, None])
                         ).astype(np.float32)
                mb = (waves, lengths, rng.randint(0, 4, size=8), np.ones(8, np.float32))
                losses["plain"].append(plain.step_accum([mb], cw)["loss"])
                losses["group"].append(grouped.step(*mb[:3], cw, valid=mb[3])["loss"])
        same = [n for n, p in plain.params.items() if torch.equal(p, grouped.params[n])]
        if len(same) < len(plain.params):
            print("differ:", [n for n in plain.params if n not in same][:8], flush=True)
        say("parallel", step=f"{backend}_world1_finetune", batch="8x3s", steps=2,
            losses=",".join(f"{x:.6f}" for x in losses["group"]),
            params_bit_equal=f"{len(same)}/{len(plain.params)}")
        check(losses["plain"] == losses["group"], f"world 1 losses {losses}")
        check(len(same) == len(plain.params),
              f"world 1 fine-tune: {len(plain.params) - len(same)} parameters differ")
        del plain, grouped
    finally:
        dist.destroy_process_group()


def check_parallel_ranks(torch, work: Path, tag: str, refs: dict, card: str,
                         sizes: dict) -> dict:
    """Hold the two ranks' rows against the one-process run, and check each
    rank's kernel launches (one per layer of a batch) and its local heads,
    lengths and contiguous bias planes; returns rank 0's report."""
    import json

    import numpy as np

    from stutter_tpu_torch.models.wavlm import WavLMConfig, wavlm_feature_lengths
    from stutter_tpu_torch.models.whisper import WhisperConfig

    rows = np.load(work / f"parallel_rows_{tag}.npz")
    reports = [json.loads((work / f"parallel_{tag}_rank{r}.json").read_text()) for r in range(2)]
    worst, bars = {}, {}
    for name, ref in refs.items():
        for c in ref:
            key = f"{name}_decoder" if c.startswith("decoder_") else name
            bars[key] = (WHISPER_FAST_DECODER_COSINE if c.startswith("decoder_")
                         else PARALLEL_POOLED_COSINE)
            worst[key] = max([worst.get(key, 0.0)] + [
                cosine_distance(torch.from_numpy(rows[f"{name}/{c}"][i]),
                                torch.from_numpy(ref[c][i])) for i in range(len(ref[c]))])
    d, ref_d = work / f"dp_store_{tag}" / "train", work / "dp_store_one" / "train"
    check((d / "embedding_metadata.csv").read_bytes()
          == (ref_d / "embedding_metadata.csv").read_bytes(), f"{tag}: the DP store's CSV differs")
    worst["dp"] = max(cosine_distance(torch.from_numpy(a), torch.from_numpy(b))
                      for p in ref_d.glob("*_embeddings.npy")
                      for a, b in zip(np.load(d / p.name), np.load(p)))
    bars["dp"] = PARALLEL_POOLED_COSINE
    wcfg, scfg = WavLMConfig.large(), WhisperConfig.large()
    on_card = reports[0]["device"] != "cpu"
    expected = {  # kernel, launches a rank (one a layer), heads a rank, length
        name: ("gated_relpos_attention", wcfg.num_hidden_layers, wcfg.num_attention_heads // 2,
               int(wavlm_feature_lengths(wcfg, sizes[name][1])))
        for name in ("wavlm_3s", "wavlm_30s")}
    expected["whisper_30s"] = ("flash_mha", scfg.encoder_layers,
                               scfg.encoder_attention_heads // 2, scfg.max_source_positions)
    clips, _, bucket_s, budget = sizes["dp"]
    dp_batches = -(-clips // int(budget / bucket_s))
    for r, rep in enumerate(reports):
        for name, (kernel, layers, heads, length) in expected.items():
            got = rep[name]
            check(got["counts"][kernel] == layers * on_card and len(got["calls"]) == layers,
                  f"{tag} rank {r} {name}: {got['counts'][kernel]} {kernel} launches, "
                  f"{len(got['calls'])} calls, expected {layers}")
            want = [heads, length] + ([[[heads, length, length], True]]
                                      if kernel == "gated_relpos_attention" else [])
            check(all(c == want for c in got["calls"]),
                  f"{tag} rank {r} {name}: calls {got['calls'][:2]}, expected {want}")
        check(reports[r]["whisper_30s"]["counts"]["whisper_log_mel"] == on_card,
              f"{tag} rank {r}: log-mel launches {rep['whisper_30s']['counts']}")
        dp_launches = rep["dp"]["counts"]["gated_relpos_attention"]
        check(dp_launches == wcfg.num_hidden_layers * dp_batches * on_card,
              f"{tag} rank {r} dp: {dp_launches} launches for {dp_batches} batches")
    say("parallel", step=f"{tag}_two_ranks", devices=",".join(r["device"] for r in reports),
        wavlm_heads_per_rank=expected["wavlm_3s"][2],
        whisper_heads_per_rank=expected["whisper_30s"][2],
        **{f"{k}_worst_pooled_cosine_dist": f"{v:.3e}" for k, v in worst.items()},
        tol=PARALLEL_POOLED_COSINE, whisper_decoder_tol=WHISPER_FAST_DECODER_COSINE,
        gated_launches_per_rank_per_batch=reports[0]["wavlm_3s"]["counts"][
            "gated_relpos_attention"],
        flash_launches_per_rank=reports[0]["whisper_30s"]["counts"]["flash_mha"],
        dp_batches=dp_batches, dp_wall_s=f"{max(r['dp']['wall_s'] for r in reports):.3f}",
        card=f'"{card}"')
    for k, v in worst.items():
        check(v <= bars[k], f"{tag} {k}: pooled cosine distance {v:.3e} > {bars[k]}")
    return reports[0]


def phase_parallel(torch, work: Path, card: str, device: str = "cuda",
                   sizes: dict = PARALLEL_SIZES) -> dict:
    """The port's process groups at full width (WavLM-Large and
    Whisper-large, seeded, fast): a group of one (parallel_world1); two
    gloo ranks sharing the card for tensor-parallel WavLM and Whisper and a
    data-parallel extraction, held to the one-process run
    (check_parallel_ranks); the sharded fine-tune dryrun on two gloo ranks;
    and, with two cards or more, the same over NCCL and the data-parallel
    audio-s/s at 1 and 2 cards. Returns rank 0's launches and calls of the
    tensor-parallel runs."""
    import json

    from stutter_tpu_torch.extract.pipeline import (
        ExtractionPipeline,
        WavLMExtractor,
        WhisperExtractor,
    )
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.parallel.dryrun import dryrun_multichip
    from stutter_tpu_torch.parallel.mesh import launch

    on_card = device == "cuda"
    cards = on_card and torch.cuda.device_count() >= 2
    parallel_world1(torch, work, card, device, sizes)

    clips, seconds, _, _ = sizes["dp"]
    dp_audio_s = write_corpus(work / "dp_corpus", {"train": clips}, seconds, seed=13)
    inputs = parallel_inputs(work, sizes)
    ex = WavLMExtractor(load_fast(torch, work, "wavlm", device), device, preset="fast")
    refs, one_ms = {}, {}
    for name in ("wavlm_3s", "wavlm_30s"):
        refs[name] = ex(host_batch(*inputs[name], sizes[name][2]))
        if cards:
            one_ms[name] = batch_ms(torch, ex, host_batch(*inputs[name], sizes[name][2]))
    batcher = dp_batcher(ex.frame_align, sizes)
    ex.warmup(batcher)
    meta = create_metadata_from_files(str(work / "dp_corpus"))
    t0 = time.perf_counter()
    ExtractionPipeline(ex, batcher=batcher, checkpoint_interval=10_000).run(
        meta, str(work / "dp_store_one"), splits=("train",))
    sync(torch, device)
    one_wall = time.perf_counter() - t0
    del ex
    ex = WhisperExtractor(load_fast(torch, work, "whisper", device), device, preset="fast")
    refs["whisper_30s"] = ex(host_batch(*inputs["whisper_30s"], sizes["whisper_30s"][2]))
    if cards:
        one_ms["whisper_30s"] = batch_ms(torch, ex, host_batch(*inputs["whisper_30s"],
                                                               sizes["whisper_30s"][2]))
    del ex
    if on_card:
        torch.cuda.empty_cache()

    launch(parallel_rank, 2, (str(work), "gloo", device, sizes), device_type=device,
           backend="gloo", store_dir=str(work))
    report = check_parallel_ranks(torch, work, "gloo", refs, card, sizes)
    dryrun_multichip(2, device=device, backend="gloo")
    say("parallel", step="dryrun_gloo", ranks=2, mesh="data=1 model=2", ok=True)

    if not cards:
        say("parallel", step="nccl_world2", result="not run (1 card)")
        return report
    scale_audio_s = write_corpus(work / "timing_corpus", {"train": SCALING_CLIPS}, (2.0, 3.0),
                                 seed=2)
    ex = WavLMExtractor(load_fast(torch, work, "wavlm", device), device, preset="fast")
    batcher = scaling_batcher(ex.frame_align)
    ex.warmup(batcher)
    scale_one = scaling_walls(torch, ex, batcher,
                              create_metadata_from_files(str(work / "timing_corpus")), work, "one")
    del ex
    torch.cuda.empty_cache()
    launch(parallel_rank, 2, (str(work), "nccl", device, sizes), device_type=device,
           backend="nccl", store_dir=str(work))
    report = check_parallel_ranks(torch, work, "nccl", refs, card, sizes)
    dryrun_multichip(2, device=device)
    ranks = [json.loads((work / f"parallel_nccl_rank{r}.json").read_text()) for r in range(2)]
    two_wall = max(r["dp"]["wall_s"] for r in ranks)
    scale_two = [max(walls) for walls in zip(*(r["scaling_wall_s"] for r in ranks))]
    say("parallel", step="nccl_world2", dp_clips=len(meta), dp_audio_s=f"{dp_audio_s:.1f}",
        dp_one_card_audio_s_per_s=f"{dp_audio_s / one_wall:.1f}",
        dp_two_cards_audio_s_per_s=f"{dp_audio_s / two_wall:.1f}",
        scaling_clips=SCALING_CLIPS, scaling_audio_s=f"{scale_audio_s:.1f}",
        one_card_audio_s_per_s=",".join(f"{scale_audio_s / w:.1f}" for w in scale_one),
        two_cards_audio_s_per_s=",".join(f"{scale_audio_s / w:.1f}" for w in scale_two),
        speedup_of_medians=f"{median(scale_one) / median(scale_two):.3f}",
        speedup_range=f"{min(scale_one) / max(scale_two):.3f}-"
                      f"{max(scale_one) / min(scale_two):.3f}", card=f'"{card}"')
    # tensor parallelism's time: a batch's wall ms on one card against TP = 2
    # over two, TP_TIMED_CALLS calls (the median; of two ranks the slower),
    # the host's enqueue ms, a profiled call's device ms, and one block's
    # all-reduce alone (two a layer)
    fields = {}
    for name, one in one_ms.items():
        tp = {key: max(median(r[name]["timing"][key]) for r in ranks)
              for key in ("ms", "enqueue_ms")}
        tp_device = max(r[name]["timing"]["device_ms"] for r in ranks)
        tp_nccl = max(r[name]["timing"]["nccl_device_ms"] for r in ranks)
        ar_ms = max(median(r[name]["all_reduce_ms"]) for r in ranks)
        fields.update({
            f"{name}_one_card_ms": f"{median(one['ms']):.2f}",
            f"{name}_tp2_ms": f"{tp['ms']:.2f}",
            f"{name}_tp2_speedup": f"{median(one['ms']) / tp['ms']:.3f}",
            f"{name}_one_card_enqueue_ms": f"{median(one['enqueue_ms']):.2f}",
            f"{name}_tp2_enqueue_ms": f"{tp['enqueue_ms']:.2f}",
            f"{name}_one_card_device_ms": f"{one['device_ms']:.2f}",
            f"{name}_tp2_device_ms": f"{tp_device:.2f}",
            f"{name}_tp2_nccl_device_ms": f"{tp_nccl:.2f}",
            f"{name}_all_reduce_ms": f"{ar_ms:.3f}",
            f"{name}_all_reduce_gb_per_s":
                f"{ranks[0][name]['all_reduce_bytes'] / ar_ms / 1e6:.1f}"})
    say("parallel", step="nccl_tp2_time", calls=TP_TIMED_CALLS, **fields, card=f'"{card}"')
    for name, one in one_ms.items():
        print(f"[parallel] top kernels, one card, {name}:\n{one['top']}", flush=True)
        print(f"[parallel] top kernels, TP = 2, rank 0, {name}:\n"
              f"{ranks[0][name]['timing']['top']}", flush=True)
    return report


# ---------------------------------------------------------------------------
# [parallel_serve]: the serving, prediction and trainer CLIs on two ranks
# ---------------------------------------------------------------------------

# the ranks a CLI spawns report to the directory this variable names: they
# inherit it, and chip_smoke.py, their main module, installs rank_spy where
# it is set (at the end of this file)
RANK_SPY_ENV = "STUTTER_SMOKE_RANK_SPY"
# two ranks' served, predicted and re-extracted rows against one process on
# the card: bf16 batches of another size, or the model cut over two ranks
# (PR 12's data-parallel bar). The predicted probabilities are not held to
# one process's: rows 9.6e-7 apart in cosine moved the [serve] head's
# probabilities by 7.35e-4 (H100 80GB HBM3); each run's CSV is held to the
# head on its own store's rows instead, and the labels to one process's.
PARALLEL_SERVE_COSINE = 1e-4
PARALLEL_PROB_ATOL = 1e-6
# a predicted label may differ from the one-process run's only where that
# run's two likeliest classes lie closer than this
PREDICTION_TIE = 1e-3
# the served requests (clips of 1-8 s, one 41 s clip to chunk, and the
# undecodable file: 48 in all), the server's max clips a round, and the
# clips of the trainer's store (8 to train on, 3 and 3 to evaluate)
PARALLEL_SERVE_SIZES = {"requests": 46, "seconds": (1.0, 8.0), "long_s": 41.0,
                        "max_clips": 64, "train_seconds": (1.0, 3.0)}


def capture_augmented(real, out: dict):
    """``real`` (the trainer's apply_data_augmentation), putting into ``out``
    the rows it appends (``rows``: each column's re-extracted rows, on rank 0
    of a plan or in one process) and the SHA-256 of the copies this process
    makes itself from the same draws on its own device (``copies_sha256``),
    which tells whether ranks on other cards would make the same bits."""
    import hashlib

    import numpy as np

    from stutter_tpu_torch.train import augment_extract

    def capture(meta, embeddings, extractor, augmentation_factor=3, minority_threshold=100,
                config=None, seed=0):
        _, waves = augment_extract._augmented_copies(meta, extractor, augmentation_factor,
                                                     minority_threshold, config, seed)
        out["copies_sha256"] = hashlib.sha256(b"".join(
            np.ascontiguousarray(w, np.float32).tobytes() for w in waves)).hexdigest()
        out_meta, out_emb = real(meta, embeddings, extractor, augmentation_factor,
                                 minority_threshold, config, seed)
        if len(out_meta) > len(meta):
            out["rows"] = {c: a[len(meta):] for c, a in out_emb.items()}
        return out_meta, out_emb

    return capture


@contextlib.contextmanager
def augmented_rows(out: dict):
    """Inside, the trainer's re-extracted rows land in ``out``."""
    from stutter_tpu_torch.train import trainer

    real = trainer.apply_data_augmentation
    trainer.apply_data_augmentation = capture_augmented(real, out)
    try:
        yield out
    finally:
        trainer.apply_data_augmentation = real


def rank_spy(spy_dir: Path) -> None:
    """Instrument a rank that a CLI spawned: each CLI's ``main`` sets every
    kernel's launch count to 0 before it runs, and afterwards writes this
    rank's report to spy_dir/rank{r}.json: the counts, the WavLM batches it
    submitted and the heads its attention calls took, its exit code, the
    files it wrote under the run's outputs (watched on the ranks other than
    0), the server's stats and serving seconds, and cli.train's re-extracted
    rows (spy_dir/augmented_rows.npz)."""
    import builtins
    import io

    import numpy as np
    import torch.distributed as dist

    from stutter_tpu_torch.cli import predict, serve, train
    from stutter_tpu_torch.extract.pipeline import WavLMExtractor
    from stutter_tpu_torch.ops.wavlm_attention import gated_relpos_attention
    from stutter_tpu_torch.serve.server import EmbeddingServer
    from stutter_tpu_torch.train import trainer

    report, rows = {}, {}
    submit, serve_loop, warmup = WavLMExtractor.submit, EmbeddingServer.serve, WavLMExtractor.warmup

    def counted_warmup(self, batcher):
        n = warmup(self, batcher)
        report["warmup_batches"] += n
        return n

    def counted_submit(self, batch):
        report["submits"] += 1
        calls, attention_fn = [], self.attention_fn
        self.attention_fn = head_recorder(attention_fn or gated_relpos_attention, calls)
        try:
            return submit(self, batch)
        finally:
            self.attention_fn = attention_fn
            report["heads"] = sorted(set(report["heads"]) | {c[0] for c in calls})

    def timed_serve(self, requests, emit):
        t0 = time.perf_counter()
        serve_loop(self, requests, emit)
        report.update(serve_s=time.perf_counter() - t0, stats=self.stats())

    def spied(real):
        def main(argv):
            rank = dist.get_rank()
            roots = [os.path.abspath(argv[argv.index(f) + 1]) for f in
                     ("--output_dir", "--results_dir", "--keep_embeddings_dir") if f in argv]
            if "--output" in argv:
                roots.append(os.path.dirname(os.path.abspath(argv[argv.index("--output") + 1])))
            written, real_open, real_makedirs = [], builtins.open, os.makedirs

            def under(path) -> bool:
                return isinstance(path, (str, os.PathLike)) and any(
                    os.path.abspath(path).startswith(root) for root in roots)

            def watched_open(file, mode="r", *args, **kw):
                if under(file) and any(c in mode for c in "wax+"):
                    written.append(str(file))
                return real_open(file, mode, *args, **kw)

            def watched_makedirs(name, *args, **kw):
                if under(name):
                    written.append(str(name))
                return real_makedirs(name, *args, **kw)

            report.clear()
            report.update(submits=0, warmup_batches=0, heads=[])
            rows.clear()
            if rank != 0:
                builtins.open = io.open = watched_open
                os.makedirs = watched_makedirs
            zero_counts()
            try:
                rc = real(argv)
            finally:
                builtins.open = io.open = real_open
                os.makedirs = real_makedirs
            report.update(rank=rank, rc=rc, counts=read_counts(), written=written,
                          copies_sha256=rows.get("copies_sha256"))
            if "rows" in rows:
                np.savez(spy_dir / "augmented_rows.npz", **rows["rows"])
            (spy_dir / f"rank{rank}.json").write_text(json.dumps(report))
            return rc

        return main

    WavLMExtractor.submit, WavLMExtractor.warmup = counted_submit, counted_warmup
    EmbeddingServer.serve = timed_serve
    trainer.apply_data_augmentation = capture_augmented(trainer.apply_data_augmentation, rows)
    for module in (serve, predict, train):
        module.main = spied(module.main)


@contextlib.contextmanager
def fds_to(stdout: Path, stderr: Path):
    """File descriptors 1 and 2 into files for the block: the processes
    spawned inside write there."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = [os.dup(1), os.dup(2)]
    with open(stdout, "w") as out, open(stderr, "w") as err:
        os.dup2(out.fileno(), 1)
        os.dup2(err.fileno(), 2)
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        for fd, old in zip((1, 2), saved):
            os.dup2(old, fd)
            os.close(old)


# the logfile tag of each CLI (the JAX CLIs' tags)
CLI_TAGS = {"stutter_tpu_torch.cli.serve": "serve", "stutter_tpu_torch.cli.predict": "predict",
            "stutter_tpu_torch.cli.train": "model_training"}


def spawned_cli(module: str, argv: list, spy_dir: Path, work: Path, device: str,
                backend: str | None) -> list:
    """``module``'s main on two ranks that ``spawn_cli`` starts (gloo shares
    one card; None: NCCL, one card a rank), with the rank spy. Their stdout
    goes to spy_dir/stdout.txt and their stderr to spy_dir/ranks.log, whose
    end is printed if a rank fails. They run from a working directory of their
    own, where rank 0 leaves the run's one logfile (``cli_dir``). Returns their
    reports, rank 0's first."""
    from stutter_tpu_torch.parallel.mesh import spawn_cli

    spy_dir.mkdir(parents=True)
    log = spy_dir / "ranks.log"
    os.environ[RANK_SPY_ENV] = str(spy_dir)
    try:
        with fds_to(spy_dir / "stdout.txt", log), cli_dir(work, CLI_TAGS[module]):
            spawn_cli(module, argv, 2, "cuda" if device == "cuda" else "cpu", str(work),
                      backend=backend)
    except Exception:
        print(log.read_text()[-6000:], file=sys.stderr, flush=True)
        raise
    finally:
        os.environ.pop(RANK_SPY_ENV)
    return [json.loads((spy_dir / f"rank{r}.json").read_text()) for r in range(2)]


def check_rank_launches(what: str, reports: list, n_layers: int, heads: int,
                        on_card: bool) -> list:
    """Both ranks exited 0, submitted the same batches, and launched the
    gated kernel once a layer a batch (warm-up batches too) at ``heads``
    heads, and ``check_wavlm_kernels``' other kernels. Returns the gated
    launches per rank."""
    submits = [r["submits"] for r in reports]
    batches = [r["submits"] + r["warmup_batches"] for r in reports]
    launches = [r["counts"]["gated_relpos_attention"] for r in reports]
    check([r["rc"] for r in reports] == [0, 0], f"{what}: ranks exited {reports}")
    check(submits[0] == submits[1] > 0, f"{what}: ranks submitted {submits} batches")
    check(launches == [n_layers * n * on_card for n in batches],
          f"{what}: {launches} gated launches for {batches} batches (warm-up included)")
    check(all(r["heads"] == [heads] for r in reports),
          f"{what}: attention heads {[r['heads'] for r in reports]}, expected {heads}")
    for r, n in zip(reports, batches):
        check_wavlm_kernels(f"{what} rank", r["counts"], n, on_card, n_layers)
    return launches


def prediction_ties(reference, labels: list, margin: float = PREDICTION_TIE) -> list:
    """Indices where ``labels`` differ from the reference responses' and the
    reference's two likeliest classes lie ``margin`` or farther apart."""
    out = []
    for i, (r, label) in enumerate(zip(reference, labels)):
        if label != r.prediction:
            top = sorted(r.probs.values(), reverse=True)
            if top[0] - top[1] >= margin:
                out.append(i)
    return out


def phase_parallel_serve(torch, extractor, work: Path, card: str, ckpt: Path, clf_path: Path,
                         device: str = "cuda", sizes: dict = PARALLEL_SERVE_SIZES,
                         buckets=None, max_length=None) -> dict:
    """The serving, prediction and trainer CLIs at --devices 2 against one
    process, WavLM-Large at full width and depth from the [checkpoint]
    directory, the [serve] classifier: with two gloo ranks sharing the card
    (correctness and launches, not scaling), cli.serve over JSONL at DP = 2
    and at TP = 2 (H = 8 a rank), 48 requests (a 41 s clip to chunk, an
    undecodable file), against the one-process EmbeddingServer (rows within
    1e-4 cosine, each request answered once, only the bad file failing, the
    predictions); cli.predict at DP = 2 over the [chunk] corpus (chunk
    policy) against --devices 1 (labels, the stores' rows within 1e-4, the
    CSV's probabilities the head's on its own rows);
    cli.train at DP = 2 with augmentation factor 1 on a 14-clip store
    (re-extracted rows within 1e-4 of one process's, rank 1 writing no
    file; whether each rank's own augmented copies, made from the same
    draws, equal rank 0's bit for bit, which rank 0's broadcast makes moot).
    Each rank's launches: 24 a batch, every other kernel 0. With two cards
    or more, cli.serve again over NCCL at DP = 2 and TP = 2, one card a
    rank, after a warm batch per bucket (p50/p95 and audio-s/s beside the
    one-process server's), and cli.train over NCCL (the copies across two
    cards). Returns each run's launches per rank."""
    import numpy as np

    from stutter_tpu_torch.cli import predict as predict_cli
    from stutter_tpu_torch.cli import train as train_cli
    from stutter_tpu_torch.cli.common import make_bucket_batcher
    from stutter_tpu_torch.extract.batcher import DEFAULT_BUCKETS_S, BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.extract.store import load_embeddings
    from stutter_tpu_torch.serve.classify import ServingClassifier
    from stutter_tpu_torch.serve.server import EmbeddingServer, jsonl_requests

    on_card = device == "cuda"
    cards = on_card and torch.cuda.device_count() >= 2
    cfg = extractor.cfg
    n_layers, heads = cfg.num_hidden_layers, cfg.num_attention_heads
    base = work / "parallel_serve"
    corpus = base / "corpus"
    audio_s = write_corpus(corpus, {"train": sizes["requests"]}, sizes["seconds"], seed=41,
                           long_per_split={"train": 1},
                           long_range=(sizes["long_s"], sizes["long_s"] + 0.5))
    bad = corpus / "undecodable.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    paths = sorted(str(p) for p in (corpus / "wav").glob("*.wav")) + [str(bad)]
    ids = [f"p{i:02d}" for i in range(len(paths) - 1)] + ["bad"]
    reqs = base / "requests.jsonl"
    reqs.write_text("".join(json.dumps({"id": i, "path": p}) + "\n" for i, p in zip(ids, paths)))

    # the one-process server over the same weights: the reference
    server = EmbeddingServer(
        extractor, batcher=make_bucket_batcher(extractor, None, buckets_s=buckets,
                                               audio_budget_s=sizes["max_clips"] * 3.0,
                                               max_batch=sizes["max_clips"]),
        max_wait_s=0.1, max_clips=sizes["max_clips"], long_clip_policy="chunk",
        classifier=ServingClassifier.load(str(clf_path), device=device))
    responses = []
    t0 = time.perf_counter()
    with open(reqs) as f:
        server.serve(jsonl_requests(f), responses.append)
    sync(torch, device)
    one = {"wall_s": time.perf_counter() - t0, **server.stats()}
    ref = {r.req_id: r for r in responses}
    check(sorted(ref) == sorted(ids) and [r.req_id for r in responses if not r.ok] == ["bad"],
          f"parallel_serve: one process answered {sorted(ref)}")

    argv = ["--model_type", "wavlm", "--model_name", str(ckpt), "--input", str(reqs),
            "--classifier_model", str(clf_path), "--max_wait_ms", "100",
            "--max_clips", str(sizes["max_clips"]), "--preset", "fast", "--device", device,
            "--devices", "2"] + (["--buckets", ",".join(map(str, buckets))] if buckets else [])
    runs = [("gloo", "dp2", [], "gloo"), ("gloo", "tp2", ["--tp", "2"], "gloo")]
    if cards:
        runs += [("nccl", "dp2", ["--warmup"], None), ("nccl", "tp2", ["--tp", "2", "--warmup"],
                                                       None)]
    launches = {}
    for backend, layout, extra, backend_arg in runs:
        tag = f"serve_{backend}_{layout}"
        spy = base / f"spy_{tag}"
        t_step = time.perf_counter()
        reports = spawned_cli("stutter_tpu_torch.cli.serve",
                              argv + extra + ["--output_dir", str(base / tag)], spy, work,
                              device, backend_arg)
        lines = [json.loads(line) for line in (spy / "stdout.txt").read_text().splitlines()
                 if line.startswith('{"id"')]
        got = [o["id"] for o in lines]
        check(sorted(got) == sorted(ids), f"{tag}: {len(got)} answers, {len(set(got))} "
                                          f"distinct, for {len(ids)} requests")
        failed = [o["id"] for o in lines if not o["ok"]]
        check(failed == ["bad"], f"{tag}: failed requests {failed}, expected only 'bad'")
        worst = 0.0
        for o in lines:
            if o["ok"]:
                saved = np.load(o["file"])
                worst = max([worst] + [cosine_distance(torch.from_numpy(saved[k]),
                                                       torch.from_numpy(ref[o["id"]].embeddings[c]))
                                       for k, c in enumerate(o["columns"])])
        check(worst <= PARALLEL_SERVE_COSINE,
              f"{tag}: rows {worst:.3g} from the one-process server's")
        ok = [o for o in lines if o["ok"]]
        flips = prediction_ties([ref[o["id"]] for o in ok], [o["prediction"] for o in ok])
        check(not flips, f"{tag}: predictions differ from the one-process server's at "
                         f"{[ok[i]['id'] for i in flips]}")
        changed = sum(o["prediction"] != ref[o["id"]].prediction for o in ok)
        launches[tag] = check_rank_launches(tag, reports, n_layers,
                                            heads // (2 if layout == "tp2" else 1), on_card)
        stats = reports[0]["stats"]
        say("parallel_serve", step=tag, requests=len(ids), answered=len(got),
            failed=",".join(failed), batches_per_rank=reports[0]["submits"],
            gated_launches_per_rank=",".join(map(str, launches[tag])),
            warmup_batches=reports[0]["warmup_batches"],
            expected=f"{n_layers}x{reports[0]['submits'] + reports[0]['warmup_batches']}",
            heads_per_rank=reports[0]["heads"][0], worst_cosine_vs_one_process=f"{worst:.3g}",
            tol=PARALLEL_SERVE_COSINE, predictions_changed_within_tie=changed,
            p50_ms=f"{stats['p50_s'] * 1e3:.1f}", p95_ms=f"{stats['p95_s'] * 1e3:.1f}",
            audio_s_per_s=f"{stats['audio_s_served'] / reports[0]['serve_s']:.1f}",
            one_process_p50_ms=f"{one['p50_s'] * 1e3:.1f}",
            one_process_p95_ms=f"{one['p95_s'] * 1e3:.1f}",
            one_process_audio_s_per_s=f"{one['audio_s_served'] / one['wall_s']:.1f}",
            note=("two ranks on one card: correctness and launches, not scaling"
                  if backend == "gloo" and not cards else
                  "gloo: all-reduces and gathers through the host" if backend == "gloo"
                  else "one card a rank, warm"), seconds=f"{time.perf_counter() - t_step:.1f}",
            card=f'"{card}"')

    # cli.predict over the [chunk] corpus, one process and two ranks
    pred = ["--data_dir", str(work / "chunk_corpus"), "--classifier_model", str(clf_path),
            "--model_type", "wavlm", "--model_name", str(ckpt), "--long_files", "chunk",
            "--preset", "fast", "--device", device] + (
        ["--max_length", str(max_length)] if max_length else [])
    one_csv, two_csv = base / "predict_one.csv", base / "predict_two.csv"
    t_step = time.perf_counter()
    with cli_dir(work, "predict"):
        rc = predict_cli.main(pred + ["--output", str(one_csv), "--devices", "1",
                                      "--keep_embeddings_dir", str(base / "predict_one")])
    check(rc == 0, "parallel_serve: one-process predict failed")
    reports = spawned_cli("stutter_tpu_torch.cli.predict",
                          pred + ["--output", str(two_csv), "--devices", "2",
                                  "--keep_embeddings_dir", str(base / "predict_two")],
                          base / "spy_predict", work, device, "gloo")
    launches["predict_gloo_dp2"] = check_rank_launches("predict", reports, n_layers, heads,
                                                       on_card)
    check(reports[1]["written"] == [], f"predict: rank 1 wrote {reports[1]['written']}")
    with open(one_csv, newline="") as a, open(two_csv, newline="") as b:
        rows_one, rows_two = list(csv.DictReader(a)), list(csv.DictReader(b))
    check(len(rows_one) == len(rows_two) > 0 and
          [r["path"] for r in rows_one] == [r["path"] for r in rows_two],
          f"predict: {len(rows_one)} and {len(rows_two)} rows")
    prob_cols = [c for c in rows_one[0] if c.startswith("prob_")]
    prob_err = max(abs(float(a[c]) - float(b[c])) for a, b in zip(rows_one, rows_two)
                   for c in prob_cols)
    label_diff = [a["path"] for a, b in zip(rows_one, rows_two)
                  if a["predicted_label"] != b["predicted_label"]]
    # the stores the two runs kept, file by file and row by row
    stores = [{str(p.relative_to(d)): np.load(p) for p in sorted(d.rglob("*_embeddings.npy"))}
              for d in (base / "predict_one", base / "predict_two")]
    check(sorted(stores[0]) == sorted(stores[1]) and stores[0],
          f"predict: stores hold {sorted(stores[0])} and {sorted(stores[1])}")
    row_worst = max(cosine_distance(torch.from_numpy(a), torch.from_numpy(b))
                    for name in stores[0] for a, b in zip(stores[0][name], stores[1][name]))
    row_abs = max(float(np.abs(stores[0][n] - stores[1][n]).max()) for n in stores[0])
    bit_equal = sum(np.array_equal(stores[0][n], stores[1][n]) for n in stores[0])
    # the two-rank CSV against the head on the two-rank store's rows
    meta, layers = load_embeddings(str(base / "predict_two"), "wavlm",
                                   splits=("train", "test", "devel"))
    _, probs = server.classifier.predict_rows(layers[server.classifier.layer])
    own = {m["path"]: p for m, p in zip(meta, probs)}
    check(sorted(own) == sorted(r["path"] for r in rows_two),
          "predict: the CSV's rows are not the store's")
    own_err = max(abs(float(r[f"prob_{c}"]) - own[r["path"]][c]) for r in rows_two
                  for c in own[r["path"]])
    say("parallel_serve", step="predict_gloo_dp2", clips=len(rows_one),
        batches_per_rank=reports[0]["submits"],
        gated_launches_per_rank=",".join(map(str, launches["predict_gloo_dp2"])),
        labels_equal=not label_diff, worst_row_cosine=f"{row_worst:.3g}",
        tol=PARALLEL_SERVE_COSINE, worst_row_abs=f"{row_abs:.3g}",
        files_bit_equal=f"{bit_equal}/{len(stores[0])}",
        worst_prob_abs_vs_one_process=f"{prob_err:.3g}",
        worst_prob_abs_vs_own_rows=f"{own_err:.3g}", prob_tol=PARALLEL_PROB_ATOL,
        rank1_files=0, seconds=f"{time.perf_counter() - t_step:.1f}", card=f'"{card}"')
    check(not label_diff and row_worst <= PARALLEL_SERVE_COSINE and own_err <= PARALLEL_PROB_ATOL,
          f"predict: labels differ at {label_diff}, rows by {row_worst:.3g}, probabilities "
          f"from the head on the store's rows by {own_err:.3g}")

    # cli.train with augmentation on a small store, one process and two ranks
    t_step = time.perf_counter()
    train_corpus, store = base / "train_corpus", base / "train_store"
    write_corpus(train_corpus, {"train": 8, "test": 3, "devel": 3}, sizes["train_seconds"],
                 seed=43)
    ExtractionPipeline(extractor, batcher=BucketBatcher(
        buckets_s=buckets or DEFAULT_BUCKETS_S, frame_align=extractor.frame_align)).run(
        create_metadata_from_files(str(train_corpus)), str(store / "wavlm"))
    train = ["--embeddings_dir", str(store), "--model_type", "wavlm", "--model_name", str(ckpt),
             "--classifier", "mlp", "--head_epochs", "5", "--augmentation_factor", "1",
             "--minority_threshold", "100", "--no_smote", "--preset", "fast", "--device", device]
    with augmented_rows({}) as one, cli_dir(work, "model_training"):
        rc = train_cli.main(train + ["--results_dir", str(base / "train_one"), "--devices", "1"])
    check(rc == 0, "parallel_serve: one-process train failed")
    rows_one = one["rows"]
    for backend, backend_arg in [("gloo", "gloo")] + ([("nccl", None)] if cards else []):
        tag = f"train_{backend}_dp2"
        spy, out = base / f"spy_{tag}", base / f"{tag}_results"
        reports = spawned_cli("stutter_tpu_torch.cli.train",
                              train + ["--results_dir", str(out), "--devices", "2"],
                              spy, work, device, backend_arg)
        launches[tag] = check_rank_launches(tag, reports, n_layers, heads, on_card)
        check(reports[1]["written"] == [], f"{tag}: rank 1 wrote {reports[1]['written']}")
        tree = [sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
                for d in (base / "train_one", out)]
        check(tree[0] == tree[1] and tree[0], f"{tag}: output trees differ: {tree}")
        with np.load(spy / "augmented_rows.npz") as z:
            rows_two = {c: z[c] for c in z.files}
        check(sorted(rows_two) == sorted(rows_one), f"{tag}: re-extracted {sorted(rows_two)}")
        n_aug = len(next(iter(rows_one.values())))
        worst = max(cosine_distance(torch.from_numpy(a), torch.from_numpy(b))
                    for c in rows_one for a, b in zip(rows_one[c], rows_two[c]))
        check(all(len(rows_two[c]) == n_aug for c in rows_two) and worst <= PARALLEL_SERVE_COSINE,
              f"{tag}: re-extracted rows {worst:.3g} from one process's")
        # rank 0 sends its copies; these say whether each rank's own would match
        own = [r["copies_sha256"] for r in reports]
        say("parallel_serve", step=tag, augmented_rows=n_aug,
            batches_per_rank=reports[0]["submits"],
            gated_launches_per_rank=",".join(map(str, launches[tag])),
            worst_cosine_vs_one_process=f"{worst:.3g}", tol=PARALLEL_SERVE_COSINE,
            files=len(tree[0]), rank1_files=0,
            own_copies_bit_equal_across_ranks=own[0] == own[1],
            own_copies_bit_equal_to_one_process=own == [one["copies_sha256"]] * 2,
            cards="two" if cards else "one_shared",
            seconds=f"{time.perf_counter() - t_step:.1f}", card=f'"{card}"')
        t_step = time.perf_counter()
    return launches


# ---------------------------------------------------------------------------
# [serve_combined], [train_whisper]: the two CLI configurations left
# ---------------------------------------------------------------------------


def phase_serve_combined(torch, wavlm_ex, work: Path, card: str, wavlm_ckpt: Path,
                         whisper_ckpt: Path, device: str = "cuda", durations=(1.0, 8.0),
                         requests: int = 6) -> dict:
    """cli.serve --model_type combined in-process on [checkpoint]'s WavLM-Large
    and 4 + 4-layer Whisper-large directories over ``requests`` JSONL
    requests: rc 0, every request answered, the fusion store's column names
    (each part's columns under its name, then combined_top), and each
    column's row within PARALLEL_SERVE_COSINE of that part's extractor alone
    (``wavlm_ex``, loaded from the same directory, and a WhisperExtractor of
    the Whisper directory) on the batches the server made; per batch one
    gated launch a WavLM layer, one log-mel call and one flash_mha launch a
    Whisper encoder layer. Returns the launch counts of the CLI run."""
    import io

    import numpy as np

    from stutter_tpu_torch.cli import serve as serve_cli
    from stutter_tpu_torch.extract.pipeline import WhisperExtractor
    from stutter_tpu_torch.extract.store import combined_top_key
    from stutter_tpu_torch.serve.combined import CombinedExtractor
    from stutter_tpu_torch.weights.convert import load_whisper

    on_card = device == "cuda"
    corpus = work / "combined_corpus"
    audio_s = write_corpus(corpus, {"train": requests}, durations, seed=51)
    paths = sorted(str(p) for p in (corpus / "wav").glob("*.wav"))
    reqs = work / "combined_requests.jsonl"
    reqs.write_text("".join(json.dumps({"id": f"c{i}", "path": p}) + "\n"
                            for i, p in enumerate(paths)))
    batches, submit = [], CombinedExtractor.submit

    def recorded(self, batch):
        batches.append(batch)
        return submit(self, batch)

    out = io.StringIO()
    CombinedExtractor.submit = recorded
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), cli_dir(work, "serve"):
            rc = serve_cli.main(["--model_type", "combined", "--model_name", str(wavlm_ckpt),
                                 "--whisper_model_name", str(whisper_ckpt), "--input",
                                 str(reqs), "--max_wait_ms", "100", "--preset", "fast",
                                 "--device", device, "--devices", "1"])
    finally:
        CombinedExtractor.submit = submit
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(rc == 0, f"serve_combined: cli.serve returned {rc}")
    lines = [json.loads(line) for line in out.getvalue().splitlines()
             if line.startswith('{"id"')]
    check(sorted(o["id"] for o in lines) == sorted(f"c{i}" for i in range(len(paths)))
          and all(o["ok"] for o in lines), f"serve_combined: answers {lines}")

    _, whisper_model = load_whisper(str(whisper_ckpt))
    whisper_ex = WhisperExtractor(whisper_model, device, preset="fast")
    parts = (("wavlm", wavlm_ex), ("whisper", whisper_ex))
    columns = list(dict.fromkeys(  # a response's columns: a dict's keys
        [f"{name}_{c}" for name, ex in parts for c in ex.column_names] + ["combined_top"]))
    tops = [f"{name}_{combined_top_key(ex.column_names)}" for name, ex in parts]
    alone = {}  # path -> {column: row} from each part alone, on the server's batches
    for batch in batches:
        rows = [ex(batch) for _, ex in parts]
        for i, path in enumerate(batch.paths):
            alone[path] = {f"{name}_{c}": r[c][i] for (name, _), r in zip(parts, rows)
                           for c in r}
            alone[path]["combined_top"] = np.hstack([alone[path][c] for c in tops])
    worst = 0.0
    for o in lines:
        check(list(o["embeddings"]) == columns,
              f"serve_combined: columns {list(o['embeddings'])}, expected {columns}")
        worst = max([worst] + [cosine_distance(torch.tensor(o["embeddings"][c]),
                                               torch.from_numpy(alone[o["path"]][c]))
                               for c in columns])
    n_batches, n_layers = len(batches), (wavlm_ex.cfg.num_hidden_layers,
                                         whisper_ex.cfg.encoder_layers)
    expected = {"gated_relpos_attention": n_layers[0] * n_batches * on_card,
                "pos_conv_residual": n_batches * on_card,
                "whisper_log_mel": n_batches * on_card,
                "flash_mha": n_layers[1] * n_batches * on_card}
    # the fused stem: at most once a batch (frame-aligned buckets take it)
    check(counts["wavlm_fused_stem"] <= n_batches * on_card
          and {k: v for k, v in counts.items() if v and k not in ("wavlm_fused_stem", *LN_COUNTS)}
          == {k: v for k, v in expected.items() if v},
          f"serve_combined: launches {counts}, expected {expected}")
    # the residual add and second norm of every layer of both encoders
    check(counts["layer_norm_fused"] == sum(n_layers) * n_batches * on_card,
          f"serve_combined: {counts['layer_norm_fused']} fused layer norms")
    say("serve_combined", requests=len(lines), batches=n_batches, columns=len(columns),
        gated_launches=counts["gated_relpos_attention"],
        log_mel_calls=counts["whisper_log_mel"], flash_mha_launches=counts["flash_mha"],
        worst_cosine_vs_each_part_alone=f"{worst:.3g}", tol=PARALLEL_SERVE_COSINE,
        audio_s=f"{audio_s:.1f}", wall_s=f"{wall:.2f}", card=f'"{card}"')
    check(worst <= PARALLEL_SERVE_COSINE,
          f"serve_combined: rows {worst:.3g} from each part's extractor alone")
    del whisper_ex, whisper_model
    return counts


def phase_train_whisper(torch, work: Path, card: str, whisper_ckpt: Path,
                        device: str = "cuda", durations=(1.0, 3.0)) -> dict:
    """cli.train --model_type whisper in-process on a small Whisper store
    ([checkpoint]'s 4 + 4-layer Whisper-large directory through
    ExtractionPipeline over a KSF-layout corpus: 26 training clips, two
    classes of 3), augmentation factor 2 under 5 clips a class: rc 0, 12
    augmented copies re-extracted by Whisper (one log-mel call and one
    flash_mha launch an encoder layer per batch, no other kernel); then the
    store's first batch again, unchanged and in the store's order, through
    the CLI's re-extraction (``augment_extract._embed_waves`` with the CLI's
    extractor): each row within PARALLEL_SERVE_COSINE of the store's.
    Returns the launch counts of the CLI run."""
    from stutter_tpu_torch.audio.wavio import load_audio
    from stutter_tpu_torch.cli import train as train_cli
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, WhisperExtractor
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.extract.store import load_embeddings
    from stutter_tpu_torch.train import augment_extract, trainer
    from stutter_tpu_torch.weights.convert import load_whisper

    on_card = device == "cuda"
    labels = {"train": ["no_disfluency"] * 10 + ["block"] * 10 + ["prolongation"] * 3
              + ["sound_repetition"] * 3, "test": list(KSF_LABELS), "devel": list(KSF_LABELS)}
    corpus, store, results = work / "tw_corpus", work / "tw_store", work / "tw_results"
    write_corpus(corpus, {s: len(v) for s, v in labels.items()}, durations, seed=61,
                 labels=labels)
    ex = WhisperExtractor(load_whisper(str(whisper_ckpt))[1], device, preset="fast")
    store_batches, submit = [], ex.submit

    def recorded(batch):
        store_batches.append([p for p, ok in zip(batch.paths, batch.ok) if ok])
        return submit(batch)

    ex.submit = recorded
    ExtractionPipeline(ex).run(create_metadata_from_files(str(corpus)), str(store / "whisper"))
    del ex

    seen, real_augment, real_submit = {}, trainer.apply_data_augmentation, WhisperExtractor.submit

    def augment(meta, embeddings, extractor, **kw):
        seen["extractor"] = extractor
        out_meta, out_emb = real_augment(meta, embeddings, extractor, **kw)
        seen["augmented"] = len(out_meta) - len(meta)
        return out_meta, out_emb

    def counted(self, batch):
        seen["batches"] = seen.get("batches", 0) + 1
        return real_submit(self, batch)

    trainer.apply_data_augmentation, WhisperExtractor.submit = augment, counted
    zero_counts()
    t0 = time.perf_counter()
    try:
        with cli_dir(work, "model_training"):
            rc = train_cli.main(["--embeddings_dir", str(store), "--results_dir", str(results),
                                 "--model_type", "whisper", "--model_name", str(whisper_ckpt),
                                 "--classifier", "mlp", "--head_epochs", "5",
                                 "--augmentation_factor", "2", "--minority_threshold", "5",
                                 "--no_smote", "--preset", "fast", "--device", device,
                                 "--devices", "1"])
        counts = read_counts()
    finally:
        trainer.apply_data_augmentation, WhisperExtractor.submit = real_augment, real_submit
    wall = time.perf_counter() - t0
    check(rc == 0 and (results / "best_per_layer.json").is_file(),
          f"train_whisper: cli.train returned {rc}")
    cli_ex = seen["extractor"]
    n_layers, batches = cli_ex.cfg.encoder_layers, seen.get("batches", 0)
    check(seen["augmented"] == 12 and batches == 1,
          f"train_whisper: {seen['augmented']} augmented rows in {batches} batches, "
          f"expected 12 in 1")
    expected = {"whisper_log_mel": batches * on_card, "flash_mha": n_layers * batches * on_card}
    check({k: v for k, v in counts.items() if v and k not in LN_COUNTS}
          == {k: v for k, v in expected.items() if v}
          and counts["layer_norm_fused"] == n_layers * batches * on_card,
          f"train_whisper: launches {counts}, expected {expected} and "
          f"{n_layers * batches * on_card} fused layer norms")

    meta, stored = load_embeddings(str(store), "whisper")
    row_of = {r["path"]: i for i, r in enumerate(meta)}
    first = store_batches[0]
    again = augment_extract._embed_waves(cli_ex, [load_audio(p) for p in first])
    worst = max(cosine_distance(torch.from_numpy(again[c][i]),
                                torch.from_numpy(stored[c][row_of[p]]))
                for c in cli_ex.column_names for i, p in enumerate(first))
    say("train_whisper", store_clips=len(meta), store_batches=len(store_batches),
        augmented_rows=seen["augmented"], reextract_batches=batches,
        log_mel_calls=counts["whisper_log_mel"], flash_mha_launches=counts["flash_mha"],
        expected=f"{batches},{n_layers}x{batches}", identity_clips=len(first),
        worst_cosine_vs_store=f"{worst:.3g}", tol=PARALLEL_SERVE_COSINE,
        wall_s=f"{wall:.2f}", card=f'"{card}"')
    check(worst <= PARALLEL_SERVE_COSINE,
          f"train_whisper: identity re-extraction {worst:.3g} from the store's rows")
    return counts


def write_wavlm_checkpoint(torch, model, work: Path) -> Path:
    """``model`` (f32) as [checkpoint]'s safetensors HF directory, its
    positional conv folded first as the loader folds it, so that loading the
    directory gives ``model``'s tensors."""
    g, v = fold_pos_conv(model)
    path = work / "ckpt_wavlm_safetensors" / "wavlm-large"
    write_checkpoint(torch, path, model.cfg, wavlm_hf_state(model, g, v, weight_g_v=False),
                     "safetensors", do_normalize=model.cfg.do_normalize)
    return path


def parallel_only(torch, card: str) -> None:
    """``--only-parallel``: WavLM-Large fast through [slice] (its corpus and
    store), the fast states of both models, then [parallel]; then the seeded
    WavLM-Large as a checkpoint directory, [chunk] (its corpus and store), a
    served head fitted on that store, and [parallel_serve]."""
    from stutter_tpu_torch.extract.pipeline import WavLMExtractor, WhisperExtractor
    from stutter_tpu_torch.models.wavlm import WavLMConfig
    from stutter_tpu_torch.models.whisper import WhisperConfig
    from stutter_tpu_torch.weights.convert import init_wavlm, init_whisper

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        with timed("slice"):
            ex = WavLMExtractor(init_wavlm(WavLMConfig.large(), torch.Generator().manual_seed(0)),
                                "cuda", preset="fast")
            phase_slice(torch, ex, work)
            torch.save(ex.model.state_dict(), work / "wavlm_fast.pt")
            del ex
            ex = WhisperExtractor(init_whisper(WhisperConfig.large(),
                                               torch.Generator().manual_seed(0)), "cuda",
                                  preset="fast")
            torch.save(ex.model.state_dict(), work / "whisper_fast.pt")
            del ex
            torch.cuda.empty_cache()
        with timed("parallel"):
            phase_parallel(torch, work, card)
        with timed("parallel_serve"):
            seeded = init_wavlm(WavLMConfig.large(), torch.Generator().manual_seed(0))
            ckpt = write_wavlm_checkpoint(torch, seeded, work)
            ex = WavLMExtractor(seeded, "cuda", preset="fast")
            _, store, _ = phase_chunk(torch, ex, work, card)
            head = fit_serving_head(store, work, "cuda", seeded.cfg.num_hidden_layers)
            phase_parallel_serve(torch, ex, work, card, ckpt, head)


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
    from stutter_tpu_torch.ops import relkey_attention as rk
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
        if "--only-relkey" in sys.argv[1:]:
            phase_tile_resources(_build)
            with timed("relkey_attn"):
                err, times = phase_relkey_attn(torch, rk)
            with timed("w2v_bert_slice"):
                w2v_counts = phase_w2v_bert_slice(torch, rk)
            print(json.dumps({"kernels": [{
                "name": "relkey_attention", "route": "cuda",
                "source": "stutter_tpu_torch/csrc/relkey_attention.cu", "replaces": None,
                "launches": w2v_counts["relkey_attention"], "max_abs_err": err,
                "cases": times, "w2v_bert_slice_layer_norm_launches": [
                    w2v_counts["layer_norm"], w2v_counts["layer_norm_fused"]]}]}),
                flush=True)
            return 0
        if "--only-parallel" in sys.argv[1:]:
            parallel_only(torch, card)
            print(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}), flush=True)
            return 0
        with timed("kernel"):
            wavlm_err, wavlm_times = phase_kernel(torch, attn)
        with timed("attn_bwd"):
            bwd_err, bwd_rel, bwd_times = phase_attn_bwd(torch, attn, card)
        with timed("logmel"):
            logmel_err, logmel_times = phase_logmel(torch, logmel)
        with timed("mha"):
            phase_tile_resources(_build)
            mha_err, mha_times = phase_mha(torch, mha)
        with timed("flash_mha_hd120"):
            hd120_err, hd120_times = phase_flash_mha_hd120(torch, mha)
        with timed("mha_bias"):
            mha_bias_err, mha_bias_times = phase_mha_bias(torch, mha)
        with timed("relkey_attn"):
            relkey_err, relkey_times = phase_relkey_attn(torch, rk)
        with timed("w2v_bert_slice"):
            w2v_counts = phase_w2v_bert_slice(torch, rk)
        with timed("mha_edges"):
            edge_errs = phase_tile_edges(torch, mha)
            mha_err = max(mha_err, edge_errs["flash_mha"])
            mha_bias_err = max(mha_bias_err, edge_errs["flash_mha_bias"])
        with timed("gated_edges"):
            wavlm_err = max(wavlm_err, phase_gated_edges(torch, attn))
        with timed("bwd_edges"):
            bwd_rel = max(bwd_rel, phase_bwd_edges(torch, attn))
        with timed("probe_kernels"):
            probe_numbers = phase_probe_kernels(torch, probes, card)
        with timed("probes"):
            probe_counts = phase_probes(torch, card)
        with timed("stem"):
            stem_err, stem_times = phase_stem(torch, card)
        with timed("pos_conv"):
            pos_conv_err, pos_conv_times, pos_conv_cases = phase_pos_conv(torch, card)
        with timed("layer_norm"):
            ln_ulps, ln_times, ln_cases = phase_layer_norm(torch, card)

        with tempfile.TemporaryDirectory() as tmp:
            work = Path(tmp)
            with timed("decode"):
                phase_decode(work, card)
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
            with timed("decode_flac"):
                phase_decode_flac(torch, extractor, work, card)
            with timed("path"):
                phase_kernel_path_vs_plain(torch, attn, extractor.layer_indices,
                                           extractor.model, fid_model)
            with timed("long_slice"):
                long_counts = phase_long_slice(torch, extractor, work)
            with timed("turbo_slice"):
                phase_slice(torch, turbo, work, phase="turbo_slice")
                wave, lengths = wavlm_test_batch(torch, extractor.cfg)
                zero_counts()
                phase_turbo_fidelity(
                    torch, "wavlm-large",
                    lambda m: m.encode(wave, extractor.layer_indices, lengths),
                    turbo.model, extractor.model, fid_model)
                # the f32 model keeps the plain stem; turbo and fast take the fused one
                stem_calls = read_counts()["wavlm_fused_stem"]
                check(stem_calls == 2, f"{stem_calls} fused stem calls in the turbo fidelity "
                      "batch, expected 2")
            with timed("turbo_ffn_slice"):
                turbo_ffn = WavLMExtractor(copy.deepcopy(fid_model), "cuda", preset="turbo_ffn")
                ffn_counts = phase_slice(torch, turbo_ffn, work, phase="turbo_ffn_slice")
                phase_turbo_fidelity(
                    torch, "wavlm-large",
                    lambda m: m.encode(wave, extractor.layer_indices, lengths),
                    turbo_ffn.model, extractor.model, fid_model, preset="turbo_ffn")
                del turbo_ffn, wave, lengths
            del fid_model
            torch.cuda.empty_cache()
            with timed("throughput"):
                fast_rate = phase_throughput(torch, extractor, work, card)
                turbo_rate = phase_throughput(torch, turbo, work, card)
            say("turbo", model="wavlm-large", fast_audio_s_per_s=f"{fast_rate:.1f}",
                turbo_audio_s_per_s=f"{turbo_rate:.1f}",
                turbo_over_fast=f"{turbo_rate / fast_rate:.3f}", card=f'"{card}"')
            torch.save(extractor.model.state_dict(), work / "wavlm_fast.pt")  # for [parallel]
            del extractor, turbo, base
            torch.cuda.empty_cache()

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
            with timed("whisper_gemm_stem"):
                phase_whisper_gemm_stem(torch, extractor.model, card)
            mel = whisper_features(whisper_test_clips(torch, 16, seed=5))
            idx = extractor.encoder_indices
            with timed("whisper_turbo_slice"):
                turbo = WhisperExtractor(copy.deepcopy(fid_model), "cuda", preset="turbo")
                phase_whisper_slice(torch, turbo, work, phase="whisper_turbo_slice")
                phase_turbo_fidelity(torch, "whisper-large", lambda m: m.embed(mel, idx, idx),
                                     turbo.model, extractor.model, fid_model)
            with timed("whisper_turbo_ffn_slice"):
                turbo_ffn = WhisperExtractor(copy.deepcopy(fid_model), "cuda",
                                             preset="turbo_ffn")
                whisper_ffn_counts = phase_whisper_slice(torch, turbo_ffn, work,
                                                         phase="whisper_turbo_ffn_slice")
                phase_turbo_fidelity(torch, "whisper-large", lambda m: m.embed(mel, idx, idx),
                                     turbo_ffn.model, extractor.model, fid_model,
                                     preset="turbo_ffn")
                del turbo_ffn
            del fid_model, mel
            torch.cuda.empty_cache()
            with timed("whisper_throughput"):
                fast_rate = phase_whisper_throughput(torch, extractor, work, card)
                turbo_rate = phase_whisper_throughput(torch, turbo, work, card)
            say("turbo", model="whisper-large", fast_clips_per_s=f"{fast_rate:.2f}",
                turbo_clips_per_s=f"{turbo_rate:.2f}",
                turbo_over_fast=f"{turbo_rate / fast_rate:.3f}", card=f'"{card}"')
            torch.save(extractor.model.state_dict(), work / "whisper_fast.pt")  # for [parallel]
            del extractor, turbo
            torch.cuda.empty_cache()
            with timed("whisper_v3_slice"):
                v3_counts = phase_whisper_v3_slice(torch, work, card)
            torch.cuda.empty_cache()
            with timed("parallel"):
                tp_report = phase_parallel(torch, work, card)

            with timed("finetune_path"):
                phase_finetune_path(torch, attn, WavLMConfig.large())
            torch.cuda.empty_cache()
            with timed("finetune_policies"):
                phase_finetune_policies(torch, attn, WavLMConfig.large(), card)
            torch.cuda.empty_cache()
            with timed("finetune"):
                ft_counts = phase_finetune(torch, work, card)
            torch.cuda.empty_cache()
            with timed("downstream_dsp"):
                phase_downstream_dsp(torch, card)
            with timed("downstream_heads"):
                phase_downstream_heads(torch, card)
            with timed("downstream"):
                ds_counts = phase_downstream(torch, work, card)
            torch.cuda.empty_cache()
            with timed("checkpoint"):
                loaded = phase_checkpoint(torch, work, card)
            with timed("chunk"):
                extractor = WavLMExtractor(loaded, "cuda", preset="fast")
                chunk_counts, chunk_store, chunk_rate = phase_chunk(torch, extractor, work, card)
            with timed("serve"):
                serve_counts = phase_serve(torch, extractor, chunk_store, work, card)
            with timed("parallel_serve"):
                ps_launches = phase_parallel_serve(
                    torch, extractor, work, card,
                    work / "ckpt_wavlm_safetensors" / "wavlm-large", serve_counts["head"])
            whisper_ckpt = work / "ckpt_whisper_safetensors" / "whisper-large"  # 4 + 4 layers
            with timed("serve_combined"):
                combined_counts = phase_serve_combined(
                    torch, extractor, work, card,
                    work / "ckpt_wavlm_safetensors" / "wavlm-large", whisper_ckpt)
            with timed("train_whisper"):
                tw_counts = phase_train_whisper(torch, work, card, whisper_ckpt)
            # last: no timing follows the profiler's sessions in this process
            with timed("utils"):
                utils_counts = phase_utils(torch, extractor, work, card)
            say("utils", cli_runs=len(CLI_LOGFILES), logfiles_each=1,
                tags=",".join(sorted({f.rsplit("_", 2)[0] for f in CLI_LOGFILES})),
                card=f'"{card}"')
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
         wavlm_counts["wavlm_fused_stem"], stem_err, stem_times),
        ("flash_mha_bias", "flash_mha.cu", "stutter_tpu/models/attention.py:102",
         long_counts["flash_mha_bias"], mha_bias_err, mha_bias_times),
        ("pos_conv_residual", "pos_conv.cu", None, wavlm_counts["pos_conv_residual"],
         pos_conv_err, pos_conv_times),
        ("layer_norm", "layer_norm.cu", None, wavlm_counts["layer_norm"], ln_ulps, ln_times),
        # no TPU kernel (w2v-BERT is the port's alone); its launches on the
        # path are [w2v_bert_slice]'s two batches
        ("relkey_attention", "relkey_attention.cu", None, w2v_counts["relkey_attention"],
         relkey_err, relkey_times["8x16x1499x64"]),
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
    line[0]["downstream_launches"] = ds_counts["gated_relpos_attention"]
    line[0]["chunk_launches"] = chunk_counts["gated_relpos_attention"]
    line[0]["serve_launches"] = serve_counts["gated_relpos_attention"]
    # per rank of the two-rank CLI runs: serve (DP and TP, each over gloo on
    # one card and, with two cards, over NCCL), predict and train
    line[0]["parallel_serve_launches_per_rank"] = ps_launches
    # per tensor-parallel rank at the local head counts: 8 of WavLM-Large's 16
    line[0]["tp2_launches_per_rank"] = {
        "16x8x160": tp_report["wavlm_3s"]["counts"]["gated_relpos_attention"],
        "2x8x1504": tp_report["wavlm_30s"]["counts"]["gated_relpos_attention"]}
    line[3]["tp2_launches_per_rank"] = {  # 10 of Whisper-large's 20 heads
        "4x10x1500": tp_report["whisper_30s"]["counts"]["flash_mha"]}
    # the 120-wide instance (wav2vec2 XLS-R 2B's heads) at the long buckets
    line[3]["head_dim_120"] = {"max_abs_err": hd120_err, "cases": hd120_times}
    # the turbo_ffn slices, Whisper large-v3 at 128 mels, the
    # combined server, cli.train's Whisper re-extraction, the traced batch
    line[0]["turbo_ffn_slice_launches"] = ffn_counts["gated_relpos_attention"]
    line[0]["serve_combined_launches"] = combined_counts["gated_relpos_attention"]
    line[0]["utils_trace_launches"] = utils_counts["gated_relpos_attention"]
    for row, kernel in ((line[2], "whisper_log_mel"), (line[3], "flash_mha")):
        row["whisper_turbo_ffn_slice_launches"] = whisper_ffn_counts[kernel]
        row["whisper_v3_slice_launches"] = v3_counts[kernel]
        row["serve_combined_launches"] = combined_counts[kernel]
        row["train_whisper_launches"] = tw_counts[kernel]
    line[1]["also_replaces"] = ["stutter_tpu/ops/wavlm_attention_vjp.py:68",
                                "stutter_tpu/ops/wavlm_attention_vjp.py:115"]
    line[1]["max_rel_err"] = bwd_rel
    # no Pallas kernel: the JAX package's positional conv is XLA's conv
    line[6]["jax_counterpart"] = "stutter_tpu/models/wavlm.py:316 (conv_general_dilated)"
    line[6]["cases"] = pos_conv_cases
    line[6]["long_slice_launches"] = long_counts["pos_conv_residual"]
    line[6]["chunk_launches"] = chunk_counts["pos_conv_residual"]
    line[6]["serve_launches"] = serve_counts["pos_conv_residual"]
    # no Pallas kernel: XLA fused the JAX package's norm; its error in bf16 steps
    line[7]["max_abs_err"] = None
    line[7]["max_ulps"] = ln_ulps
    line[7]["cases"] = ln_cases
    line[7]["fused_launches"] = wavlm_counts["layer_norm_fused"]
    line[7]["long_slice_launches"] = long_counts["layer_norm"]
    line[7]["w2v_bert_slice_launches"] = w2v_counts["layer_norm"]
    line[7]["w2v_bert_slice_fused_launches"] = w2v_counts["layer_norm_fused"]
    line[8]["cases"] = relkey_times
    line[9]["also_replaces"] = "scripts/attn_int8_probe.py:100"  # its pallas_call
    line[10]["also_replaces"] = "scripts/attn_softmax_variants_probe.py:98"
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if os.environ.get(RANK_SPY_ENV):  # a rank that [parallel_serve]'s CLI spawned
    rank_spy(Path(os.environ[RANK_SPY_ENV]))

if __name__ == "__main__":
    sys.exit(main())
