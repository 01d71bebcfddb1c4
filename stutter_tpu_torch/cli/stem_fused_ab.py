"""A/B of the fused WavLM stem against the plain conv stem on a CUDA card.

    python -m stutter_tpu_torch.cli.stem_fused_ab [--batch 128] [--clip_s 3.0] \\
        [--iters 15] [--preset turbo|fast]

The port's counterpart of ``scripts/stem_fused_ab.py``, with its flags and
defaults. WavLM-Large with random weights (seed 0), cast for ``--preset``,
on one full batch of noise at the frame-aligned ``--clip_s`` bucket:

- stem only: the plain ``ConvFeatureEncoder`` against
  ``ops.wavlm_stem.wavlm_fused_stem`` on the prepared wave, ms per call;
- end to end: ``WavLMModel.encode`` with ``use_fused_stem`` False and True,
  ms per call and audio-seconds per second;
- fidelity: the worst pooled-embedding cosine distance, over 4 clips and
  the 4 selected layers, of the fused path and of the plain path (both in
  the preset) from the f32 path (fidelity weights, no TF32);
- the stem launches of one fused encode.

Times are CUDA events around ``--iters`` calls, after a warm call of each, in
three rounds that take the four functions in turn; the lists hold each
round's ms per call. The last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys

FIDELITY_CLIPS = 4


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Fused vs plain WavLM stem on a CUDA card")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--clip_s", type=float, default=3.0)
    parser.add_argument("--iters", type=int, default=15)
    parser.add_argument("--preset", default="turbo", choices=["fast", "turbo"])
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import cast_for_preset, resolve_device
    from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
    from stutter_tpu_torch.models.wavlm import WavLMConfig
    from stutter_tpu_torch.ops.precision import no_tf32
    from stutter_tpu_torch.ops.wavlm_stem import wavlm_fused_stem
    from stutter_tpu_torch.weights.convert import init_wavlm

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    cfg = WavLMConfig.large()
    base = init_wavlm(cfg, torch.Generator().manual_seed(0))
    exact = copy.deepcopy(base).to(device).eval()  # the f32 path
    model = cast_for_preset(base, device, args.preset)
    n_states = cfg.num_hidden_layers + 1
    layers = (n_states - 1, n_states - 2, n_states - 3, n_states // 2)

    batcher = BucketBatcher(frame_align=(*cfg.stem_geometry, 16))
    n_samples = batcher.bucket_samples(args.clip_s)
    g = torch.Generator(device=device).manual_seed(0)
    lengths = torch.full((args.batch,), n_samples, dtype=torch.long, device=device)
    wave = wavlm_prepare_batch(torch.randn(args.batch, n_samples, device=device, generator=g)
                               * 0.1, lengths, cfg.do_normalize)

    def worst_cosine(emb, ref) -> float:
        a, r = emb.double(), ref.double()
        cos = (a * r).sum(-1) / (a.norm(dim=-1) * r.norm(dim=-1))
        return float((1 - cos).max())

    small_w, small_l = wave[:FIDELITY_CLIPS], lengths[:FIDELITY_CLIPS]
    with no_tf32():
        ref = exact.encode(small_w, layers, small_l)
    del exact
    fid = {name: worst_cosine(model.encode(small_w, layers, small_l, use_fused_stem=fused), ref)
           for name, fused in (("plain", False), ("fused", True))}

    stem = model.feature_encoder
    packed = stem.packed()
    before = wavlm_fused_stem.launches
    model.encode(wave, layers, lengths, use_fused_stem=True)
    launches = wavlm_fused_stem.launches - before
    fns = {
        "stem_plain": lambda: stem(wave, lengths),
        "stem_fused": lambda: wavlm_fused_stem(wave, *packed),
        "e2e_plain": lambda: model.encode(wave, layers, lengths, use_fused_stem=False),
        "e2e_fused": lambda: model.encode(wave, layers, lengths, use_fused_stem=True),
    }
    ms = {name: [] for name in fns}
    with torch.inference_mode():
        for fn in fns.values():  # warm: kernels built, cuDNN and the allocator settled
            fn()
        for _ in range(3):
            for name, fn in fns.items():
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(device)
                e0.record()
                for _ in range(args.iters):
                    fn()
                e1.record()
                e1.synchronize()
                ms[name].append(e0.elapsed_time(e1) / args.iters)

    audio_s = args.batch * n_samples / batcher.target_sr
    out = {
        "preset": args.preset,
        "batch": args.batch,
        "n_samples": n_samples,
        "fused_fidelity_vs_f32": fid["fused"],
        "plain_fidelity_vs_f32": fid["plain"],
        "stem_launches_per_encode": launches,
        **{f"{name}_ms": times for name, times in ms.items()},
        "e2e_plain_audio_s_per_s": audio_s / (min(ms["e2e_plain"]) / 1e3),
        "e2e_fused_audio_s_per_s": audio_s / (min(ms["e2e_fused"]) / 1e3),
        "card": card,
        "device": torch.cuda.get_device_name(device),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
