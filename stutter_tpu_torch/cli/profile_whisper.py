"""Where one Whisper-large extraction batch spends its time on a CUDA card.

    python -m stutter_tpu_torch.cli.profile_whisper [--preset fast|fidelity|turbo]

One batch of 16 clips of 30 s (the extraction CLI's default batch), noise at
full length, goes through Whisper-large's extraction path (random weights, seed
0) on the first CUDA card: the log-mel kernel, the conv stem, the 32 encoder
layers (attention through the flash kernel) with the last three states
pooled, and the one decoder step. Printed, one line each:

- ``[card]``: the card's name and power limit, as nvidia-smi gives them;
- ``[part]``: device ms of each part run on its own (log_mel, stem,
  encoder_layers, decoder_step) and of the whole path from waves to pooled
  embeddings (extract), median of 5 runs, timed with CUDA events, and the
  path's (padded) audio-seconds and clips per second;
- ``[host]``: ms the host takes to enqueue one extract (its call returns
  before the device finishes);
- ``[kernel]``: the 25 device kernels by total time in one extract, from
  ``torch.profiler``, with their launch counts.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import sys
import time

RUNS = 5
TOP = 25
BATCH = 16


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Device-time breakdown of one Whisper-large extraction batch")
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"])
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stutter_tpu_torch.extract.pipeline import WhisperExtractor, resolve_device
    from stutter_tpu_torch.frontend.whisper_frontend import whisper_features
    from stutter_tpu_torch.models.whisper import WhisperConfig, whisper_decoder_step
    from stutter_tpu_torch.ops.flash_mha import mha_self
    from stutter_tpu_torch.ops.logmel import WHISPER_N_SAMPLES, WHISPER_SR
    from stutter_tpu_torch.ops.precision import no_tf32
    from stutter_tpu_torch.weights.convert import init_whisper

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"[card] {card}", flush=True)
    cfg = WhisperConfig.large()
    ex = WhisperExtractor(init_whisper(cfg, torch.Generator().manual_seed(0)), device,
                          preset=args.preset)
    model, enc_idx, dec_idx = ex.model, ex.encoder_indices, ex.decoder_indices
    B = BATCH
    g = torch.Generator(device=device).manual_seed(0)
    wave = torch.randn(B, WHISPER_N_SAMPLES, device=device, generator=g) * 0.1
    audio_s = B * WHISPER_N_SAMPLES / WHISPER_SR

    def median_ms(fn) -> float:
        fn()
        times = []
        for _ in range(RUNS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def extract():
        mel = whisper_features(wave, n_mels=cfg.num_mel_bins)
        return model.embed(mel, enc_idx, dec_idx)

    precision = no_tf32() if args.preset == "fidelity" else contextlib.nullcontext()
    with torch.inference_mode(), precision:
        mel = whisper_features(wave, n_mels=cfg.num_mel_bins)
        x = model.encoder.stem(mel)
        enc_last, _ = model.encoder(mel, lambda i, h: None)

        def layers():
            h = x
            for layer in model.encoder.layers:
                h = layer(h, mha_self)
            return h

        parts = {
            "log_mel": lambda: whisper_features(wave, n_mels=cfg.num_mel_bins),
            "stem": lambda: model.encoder.stem(mel),
            "encoder_layers": layers,
            "decoder_step": lambda: whisper_decoder_step(model.decoder, enc_last, 0),
            "extract": extract,
        }
        for name, fn in parts.items():
            ms = median_ms(fn)
            rate = (f" audio_s={audio_s:.2f} audio_s_per_s={audio_s / (ms / 1e3):.1f}"
                    f" clips_per_s={B / (ms / 1e3):.2f}")
            print(f"[part] {name} device_ms={ms:.3f}{rate if name == 'extract' else ''}",
                  flush=True)
        enqueue = []
        for _ in range(RUNS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            extract()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize(device)
        print(f"[host] extract enqueue_ms={statistics.median(enqueue):.3f}", flush=True)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            extract()
            torch.cuda.synchronize(device)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[kernels] preset={args.preset} batch={B}x30s distinct={len(kernels)} "
          f"device_ms_total={total_ms:.3f}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"[kernel] ms={e.self_device_time_total / 1e3:.3f} count={e.count} "
              f"name={e.key[:140]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
