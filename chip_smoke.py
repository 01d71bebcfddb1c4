#!/usr/bin/env python3
"""Run the PyTorch port's WavLM-Large and Whisper-large extraction on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, one line each on stdout ([time] lines give each phase's seconds):
1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from stutter_tpu_torch/csrc (nvcc, sm_90a,
   one process per source);
3. kernel: the WavLM attention kernel against its plain PyTorch version on
   the card, at the extraction path's shapes and a ragged length, with masks
   that cut clips short: errors against stated tolerances, median times;
4. logmel: the Whisper log-mel kernel against its plain version at 16 x 30 s
   (80 and 128 mels; silent, quiet and zero-padded clips among them);
5. mha: the Whisper encoder's flash-attention kernel against its plain
   version at 16 x 20 x 1500 x 64 in bf16 and f32, with key padding and at a
   ragged length;
6. slice: a synthetic 16 kHz corpus through ExtractionPipeline.run with
   WavLM-Large (random weights, seed 0) in the fast preset; checks the store,
   the checkpoints, that every attention call went through the kernel, and
   that a resumed run skips finished rows;
7. path: one 3 s bucket batch through WavLMModel.encode with the kernel and
   with the plain attention, in the fast and the fidelity preset;
8. throughput: the fast WavLM extraction's audio-seconds per second over
   1280 clips of 2-3 s, after a warm batch, and one batch's device time;
9. whisper_slice: a synthetic corpus through a default-constructed
   ExtractionPipeline with Whisper-large (random weights, seed 0, fast):
   the store, the checkpoints, one log-mel launch per batch and 32 attention
   launches per batch, and resume;
10. whisper_path: one 16 x 30 s batch through the kernel path and the plain
   path (plain log-mel and attention), in both presets;
11. whisper_throughput: fast, 64 clips of 2-3 s in batches of 16, after a
   warm batch: clips/s, audio-s/s, one batch's device time.
Each extraction path is driven with every kernel's launch count set to 0
just before it and read just after. Then one JSON line with the kernels'
numbers and, last, the device line. Any failed check exits non-zero; with
no CUDA card it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
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


def write_corpus(root: Path, n_per_split: dict, dur_range, seed: int) -> float:
    """KSF layout: wav/{split}_{i}.wav at 16 kHz plus lab/{split}.csv.
    Returns the total audio seconds."""
    import numpy as np

    from stutter_tpu_torch.audio.wavio import write_wav

    rng = np.random.RandomState(seed)
    (root / "wav").mkdir(parents=True)
    (root / "lab").mkdir()
    total = 0.0
    labels = ("no_disfluency", "block", "prolongation", "sound_repetition")
    for split, n in n_per_split.items():
        rows = []
        for i in range(n):
            name = f"{split}_{i:04d}.wav"
            t = np.arange(int(rng.uniform(*dur_range) * 16000)) / 16000
            f0 = rng.uniform(100, 600)
            x = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.randn(len(t))
            write_wav(str(root / "wav" / name), x / max(1.0, np.abs(x).max() * 1.05), 16000)
            rows.append((name, labels[rng.randint(len(labels))]))
            total += len(t) / 16000
        with open(root / "lab" / f"{split}.csv", "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(("filename", "label"))
            w.writerows(rows)
    return total


def phase_kernel(torch, attn):
    """Kernel against its plain version; returns (summary, headline timings)."""
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
        ms, plain_ms = time_pair(torch, lambda: attn.gated_relpos_attention(*args),
                                 lambda: attn.gated_relpos_attention_reference(*args))
        say("kernel", shape=f"{B}x{H}x{L}x64", dtype=str(dtype).split(".")[-1],
            layout=layout, max_abs_err=f"{max_abs:.3e}", max_abs_tol=tol_abs,
            cosine_dist=f"{cos:.3e}", cosine_tol=tol_cos, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}")
        check(max_abs <= tol_abs and cos <= tol_cos,
              f"kernel disagrees with its plain version at {B}x{H}x{L} {dtype}")
        worst_abs = max(worst_abs, max_abs)
        if headline is None:
            headline = (ms, plain_ms)
    return worst_abs, headline


def time_pair(torch, fn_a, fn_b, runs: int = 20):
    """Median ms of each, timed per launch with CUDA events, in turns."""
    for _ in range(3):
        fn_a(), fn_b()
    times = ([], [])
    for _ in range(runs):
        for fn, acc in ((fn_a, times[0]), (fn_b, times[1])):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            acc.append(e0.elapsed_time(e1))
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
    from stutter_tpu_torch.ops.flash_mha import flash_mha
    from stutter_tpu_torch.ops.logmel import whisper_log_mel
    from stutter_tpu_torch.ops.wavlm_attention import gated_relpos_attention

    return {"gated_relpos_attention": gated_relpos_attention, "flash_mha": flash_mha,
            "whisper_log_mel": whisper_log_mel}


def zero_counts() -> None:
    for wrapper in kernel_wrappers().values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in kernel_wrappers().items()}


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


def phase_slice(torch, extractor, work: Path):
    import numpy as np

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    cfg, layers, dim = extractor.cfg, extractor.layer_indices, extractor.embedding_dim
    corpus, out = work / "corpus", work / "store"
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
    say("slice", clips=len(meta), audio_s=f"{audio_s:.2f}", batches=seen["batches"],
        launches=launches, expected=f"{cfg.num_hidden_layers}x{seen['batches']}",
        wall_s=f"{wall:.2f}",
        store=f"3 splits x layers {','.join(map(str, layers))} x [n,{dim}]")

    check_resume(torch, pipe, extractor, meta, out, results)
    return launches


def phase_kernel_path_vs_plain(torch, attn, layers, fast_model, fid_model):
    """One 3 s bucket batch through encode with the kernel and the plain attention."""
    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
    from stutter_tpu_torch.ops.precision import no_tf32

    device = fast_model.rel_attn_embed.device
    g = torch.Generator(device=device).manual_seed(1)
    B, T = 16, 51_280  # the 3 s bucket: L = 160 frames
    lengths = torch.randint(8_000, T + 1, (B,), device=device, generator=g)
    lengths[0] = T
    wave = torch.randn(B, T, device=device, generator=g) * 0.1
    wave = wavlm_prepare_batch(wave, lengths, fast_model.cfg.do_normalize)
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


def phase_throughput(torch, extractor, work: Path, card: str):
    """The fast pipeline's audio-s/s over 10 full 3 s batches, and the device
    time of one batch's encode alone (input already on the card)."""
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
    pipe.run(meta, str(work / "timing_store"), splits=("train",))
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
    say("throughput", preset="fast", clips=len(meta), audio_s=f"{audio_s:.1f}",
        wall_s=f"{wall:.3f}", audio_s_per_s=f"{audio_s / wall:.1f}",
        batch=f"{len(batch.lengths)}x3s", encode_device_ms=f"{encode_ms:.1f}",
        encode_audio_s_per_s=f"{batch.audio_seconds / (encode_ms / 1e3):.1f}",
        card=f'"{card}"')


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


def phase_logmel(torch, logmel):
    """Log-mel kernel against its plain version at the path's 16 x 30 s;
    returns (worst max-abs error, (ms, plain ms) at 80 mels)."""
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
        ms, plain_ms = time_pair(torch, lambda: logmel.whisper_log_mel(wave, n_mels),
                                 lambda: logmel.log_mel_spectrogram_reference(wave, n_mels))
        say("logmel", shape="16x480000", n_mels=n_mels, max_abs_err=f"{max_abs:.3e}",
            max_abs_tol=LOGMEL_MAX_ABS, silent_clip_exact=silent_ok, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}")
        check(max_abs <= LOGMEL_MAX_ABS and silent_ok,
              f"log-mel kernel disagrees with its plain version at {n_mels} mels")
        worst = max(worst, max_abs)
        headline = headline or (ms, plain_ms)
    return worst, headline


def phase_mha(torch, mha):
    """Flash-attention kernel against its plain version; returns (worst
    max-abs error, (ms, plain ms) at the bf16 encoder shape)."""
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
        ms, plain_ms = time_pair(torch, lambda: mha.flash_mha(q, k, v, kv_valid),
                                 lambda: mha.flash_mha_reference(q, k, v, kv_valid))
        say("mha", shape=f"{B}x{H}x{L}x64", dtype=str(dtype).split(".")[-1],
            kv_valid=",".join(map(str, kv)) if kv else "all", max_abs_err=f"{max_abs:.3e}",
            max_abs_tol=tol_abs, cosine_dist=f"{cos:.3e}", cosine_tol=tol_cos,
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}")
        check(max_abs <= tol_abs and cos <= tol_cos,
              f"flash_mha disagrees with its plain version at {B}x{H}x{L} {dtype} kv={kv}")
        worst = max(worst, max_abs)
        headline = headline or (ms, plain_ms)
    return worst, headline


def phase_whisper_slice(torch, extractor, work: Path) -> dict:
    """The Whisper slice through a default-constructed pipeline; returns the
    kernels' launch counts."""
    import numpy as np

    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    cfg, dim = extractor.cfg, extractor.embedding_dim
    corpus, out = work / "whisper_corpus", work / "whisper_store"
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
    check(counts["gated_relpos_attention"] == 0, "the Whisper path launched WavLM's kernel")
    say("whisper_slice", clips=len(meta), audio_s=f"{audio_s:.2f}", batches=batches,
        batch=pipe.batcher.batch_size_for(30.0), log_mel_launches=counts["whisper_log_mel"],
        flash_mha_launches=counts["flash_mha"],
        expected=f"{batches},{cfg.encoder_layers}x{batches}", wall_s=f"{wall:.2f}",
        store=f"3 splits x {','.join(extractor.column_names)} x [n,{dim}]")
    check_resume(torch, pipe, extractor, meta, out, results)
    return counts


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


def phase_whisper_throughput(torch, extractor, work: Path, card: str):
    """The fast Whisper pipeline over 64 clips of 2-3 s in batches of 16 (the
    CLI's batch), after a warm batch, and one batch's device time."""
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
    pipe.run(meta, str(work / "whisper_timing_store"), splits=("train",))
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
    say("whisper_throughput", preset="fast", clips=len(meta), audio_s=f"{audio_s:.1f}",
        wall_s=f"{wall:.3f}", clips_per_s=f"{len(meta) / wall:.2f}",
        audio_s_per_s=f"{audio_s / wall:.1f}", batch=f"{len(batch.lengths)}x30s",
        encode_device_ms=f"{encode_ms:.1f}",
        encode_clips_per_s=f"{len(batch.lengths) / (encode_ms / 1e3):.2f}",
        card=f'"{card}"')


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
    from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
    from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel
    from stutter_tpu_torch.ops import _build
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
        with timed("logmel"):
            logmel_err, logmel_times = phase_logmel(torch, logmel)
        with timed("mha"):
            mha_err, mha_times = phase_mha(torch, mha)

        with tempfile.TemporaryDirectory() as tmp:
            with timed("wavlm_init"):
                cfg = WavLMConfig.large()
                base = init_wavlm(cfg, torch.Generator().manual_seed(0))
                fid_model = WavLMModel(cfg, device="cuda")
                fid_model.load_state_dict(base.state_dict())
                extractor = WavLMExtractor(base, "cuda", preset="fast")  # casts to bf16
            with timed("slice"):
                wavlm_launches = phase_slice(torch, extractor, Path(tmp))
            with timed("path"):
                phase_kernel_path_vs_plain(torch, attn, extractor.layer_indices,
                                           extractor.model, fid_model)
            del fid_model
            with timed("throughput"):
                phase_throughput(torch, extractor, Path(tmp), card)
            del extractor, base

            with timed("whisper_init"):
                cfg = WhisperConfig.large()
                base = init_whisper(cfg, torch.Generator().manual_seed(0))
                fid_model = WhisperModel(cfg, device="cuda")
                fid_model.load_state_dict(base.state_dict())
                extractor = WhisperExtractor(base, "cuda", preset="fast")  # casts to bf16
                del base
            with timed("whisper_slice"):
                whisper_counts = phase_whisper_slice(torch, extractor, Path(tmp))
            with timed("whisper_path"):
                phase_whisper_path(torch, extractor.model, fid_model)
            del fid_model
            with timed("whisper_throughput"):
                phase_whisper_throughput(torch, extractor, Path(tmp), card)
    except CheckFailed as e:
        print(f"FAILED: {e}", flush=True)
        return 1

    kernels = [
        ("gated_relpos_attention", "stutter_tpu_torch/csrc/wavlm_attention.cu",
         "stutter_tpu/ops/wavlm_attention_pallas.py:31", wavlm_launches, wavlm_err,
         wavlm_times),
        ("whisper_log_mel", "stutter_tpu_torch/csrc/logmel.cu",
         "stutter_tpu/ops/logmel_pallas.py:43", whisper_counts["whisper_log_mel"],
         logmel_err, logmel_times),
        ("flash_mha", "stutter_tpu_torch/csrc/flash_mha.cu",
         "stutter_tpu/models/attention.py:54", whisper_counts["flash_mha"], mha_err,
         mha_times),
    ]
    line = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": err, "ms": times[0], "plain_ms": times[1]}
            for name, source, replaces, launches, err, times in kernels]
    line[0]["also_replaces"] = "stutter_tpu/ops/wavlm_attention_pallas.py:93"
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
