#!/usr/bin/env python3
"""Run the PyTorch port's WavLM-Large extraction on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, one line each on stdout:
1. device: the card's name and power limit (nvidia-smi);
2. build: compile the CUDA kernels from stutter_tpu_torch/csrc (nvcc, sm_90a);
3. the attention kernel against its plain PyTorch version on the card, at the
   extraction path's shapes and a ragged length, with masks that cut clips
   short: errors against stated tolerances, median times (CUDA events);
4. the slice end to end: a synthetic 16 kHz corpus through
   ExtractionPipeline.run with WavLM-Large (random weights, seed 0) in the
   fast preset; checks the store, the checkpoints, that every attention call
   went through the kernel, and that a resumed run skips finished rows;
5. one 3 s bucket batch through WavLMModel.encode with the kernel and with the
   plain attention, in the fast and the fidelity preset;
6. the fast extraction's throughput in audio-seconds per second over a corpus
   of 1280 clips of 2-3 s (10 full batches), after a warm batch, and the
   device time of one batch's encode alone.
Then one JSON line with the kernel's numbers and, last, the device line.
Any failed check exits non-zero; with no CUDA card it exits non-zero at once.
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


def phase_slice(torch, attn, extractor, work: Path):
    import numpy as np

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.checkpoint import find_latest_checkpoint, load_checkpoint
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    cfg, layers, dim = extractor.cfg, extractor.layer_indices, extractor.embedding_dim
    corpus, out = work / "corpus", work / "store"
    audio_s = write_corpus(corpus, {"train": 12, "test": 6, "devel": 6}, (0.5, 4.0), seed=0)
    meta = create_metadata_from_files(str(corpus))
    pipe = ExtractionPipeline(extractor, batcher=BucketBatcher(frame_align=extractor.frame_align),
                              checkpoint_interval=5)
    seen = count_submits(extractor)
    attn.gated_relpos_attention.launches = 0
    t0 = time.perf_counter()
    results = pipe.run(meta, str(out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = attn.gated_relpos_attention.launches
    del extractor.submit
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

    # resume: rows in each split's latest checkpoint are not extracted again
    first = {s: (out / s / "embedding_metadata.csv").read_bytes() for s in results}
    done = {}
    for split in results:
        n = find_latest_checkpoint(str(out), split)
        done[split] = {r["path"] for r in load_checkpoint(str(out), split, n)} if n else set()
    seen = count_submits(extractor)
    pipe.run(meta, str(out), resume=True)
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
    return launches


def phase_kernel_path_vs_plain(torch, attn, layers, fast_model, fid_model):
    """One 3 s bucket batch through encode with the kernel and the plain attention."""
    from stutter_tpu_torch.extract.pipeline import _no_tf32
    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch

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
        with _no_tf32() if name == "fidelity" else contextlib.nullcontext():
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

    from stutter_tpu_torch.extract.pipeline import WavLMExtractor
    from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
    from stutter_tpu_torch.ops import _build
    from stutter_tpu_torch.ops import wavlm_attention as attn
    from stutter_tpu_torch.weights.convert import init_wavlm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(card, flush=True)
    say("device", name=f'"{torch.cuda.get_device_name(0)}"', count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    lib, build_s = _build.build()
    say("build", seconds=f"{build_s:.2f}", library=lib.relative_to(ROOT))

    try:
        worst_abs, (ms, plain_ms) = phase_kernel(torch, attn)

        cfg = WavLMConfig.large()
        base = init_wavlm(cfg, torch.Generator().manual_seed(0))
        fid_model = WavLMModel(cfg, device="cuda")
        fid_model.load_state_dict(base.state_dict())
        extractor = WavLMExtractor(base, "cuda", preset="fast")  # casts to bf16
        with tempfile.TemporaryDirectory() as tmp:
            launches = phase_slice(torch, attn, extractor, Path(tmp))
            phase_kernel_path_vs_plain(torch, attn, extractor.layer_indices,
                                       extractor.model, fid_model)
            del fid_model
            phase_throughput(torch, extractor, Path(tmp), card)
    except CheckFailed as e:
        print(f"FAILED: {e}", flush=True)
        return 1

    print(json.dumps({"kernels": [{
        "name": "gated_relpos_attention",
        "route": "cuda",
        "source": "stutter_tpu_torch/csrc/wavlm_attention.cu",
        "replaces": "stutter_tpu/ops/wavlm_attention_pallas.py:31",
        "also_replaces": "stutter_tpu/ops/wavlm_attention_pallas.py:93",
        "launches": launches,
        "max_abs_err": worst_abs,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
