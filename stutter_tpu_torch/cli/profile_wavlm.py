"""Where one WavLM encode spends its time on a CUDA card.

    python -m stutter_tpu_torch.cli.profile_wavlm [--preset fast|fidelity|turbo] [--seconds 3.0]

One full batch of the ``--seconds`` bucket, shaped as the extraction path
shapes it (default batcher: 128 clips at 3 s, 12 at 30 s; frame-aligned), of
noise at full length goes through WavLM-Large's ``WavLMModel.encode`` with
random weights (seed 0) on the first CUDA card. Printed, one line each:

- ``[card]``: the card's name and power limit, as nvidia-smi gives them;

- ``[part]``: device ms of each part run on its own (the conv stem, the
  feature projection, the positional conv, the layer stack) and of the whole
  encode, median of 5 runs, timed with CUDA events, and the encode's
  audio-seconds per second;
- ``[host]``: ms the host takes to enqueue one encode (its call returns
  before the device finishes);
- ``[kernel]``: the 25 device kernels by total time in one encode,
  from ``torch.profiler``, with their launch counts.
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


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Device-time breakdown of one WavLM encode")
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"])
    parser.add_argument("--seconds", type=float, default=3.0, help="Bucket length")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import WavLMExtractor, resolve_device
    from stutter_tpu_torch.ops.precision import no_tf32
    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
    from stutter_tpu_torch.models.wavlm import WavLMConfig, wavlm_feature_lengths
    from stutter_tpu_torch.ops.wavlm_attention import gated_relpos_attention
    from stutter_tpu_torch.weights.convert import init_wavlm

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"[card] {card}", flush=True)
    cfg = WavLMConfig.large()
    ex = WavLMExtractor(init_wavlm(cfg, torch.Generator().manual_seed(0)), device,
                        preset=args.preset)
    model, layers = ex.model, ex.layer_indices
    batcher = BucketBatcher(frame_align=ex.frame_align)
    B, T = batcher.batch_size_for(args.seconds), batcher.bucket_samples(args.seconds)
    g = torch.Generator(device=device).manual_seed(0)
    lengths = torch.full((B,), T, dtype=torch.long, device=device)
    wave = wavlm_prepare_batch(torch.randn(B, T, device=device, generator=g) * 0.1,
                               lengths, cfg.do_normalize)

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

    precision = no_tf32() if args.preset == "fidelity" else contextlib.nullcontext()
    with torch.inference_mode(), precision:
        feats = model.feature_encoder(wave, lengths)
        hidden = model.feature_projection(feats)
        L = hidden.shape[1]
        frame_mask = (torch.arange(L, device=device)[None]
                      < wavlm_feature_lengths(cfg, lengths)[:, None])
        key_mask_bias = torch.where(frame_mask, 0.0, -1e9).float()
        bias = model.position_bias(L)

        def stack():
            h = hidden
            for layer in model.layers:
                h = layer(h, bias, key_mask_bias, gated_relpos_attention).to(h.dtype)
            return h

        parts = {
            "stem": lambda: model.feature_encoder(wave, lengths),
            "feature_projection": lambda: model.feature_projection(feats),
            "pos_conv": lambda: model.pos_conv(hidden),
            "layers": stack,
            "encode": lambda: model.encode(wave, layers, lengths),
        }
        for name, fn in parts.items():
            ms = median_ms(fn)
            audio_s = B * T / batcher.target_sr
            rate = f" audio_s={audio_s:.2f} audio_s_per_s={audio_s / (ms / 1e3):.1f}"
            print(f"[part] {name} device_ms={ms:.3f}{rate if name == 'encode' else ''}",
                  flush=True)
        enqueue = []
        for _ in range(RUNS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            model.encode(wave, layers, lengths)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize(device)
        print(f"[host] encode enqueue_ms={statistics.median(enqueue):.3f}", flush=True)

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.encode(wave, layers, lengths)
            torch.cuda.synchronize(device)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[kernels] preset={args.preset} batch={B}x{args.seconds}s L={L} "
          f"distinct={len(kernels)} device_ms_total={total_ms:.3f}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP]:
        print(f"[kernel] ms={e.self_device_time_total / 1e3:.3f} count={e.count} "
              f"name={e.key[:140]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
