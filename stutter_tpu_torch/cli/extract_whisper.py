"""Whisper embedding extraction CLI on one GPU (flags of ``stutter_tpu.cli.extract_whisper``).

    python -m stutter_tpu_torch.cli.extract_whisper --data_dir <corpus> \\
        --output_dir <out> --random_init [--preset fast|fidelity] [--device cuda]

``--device`` names the torch device (default ``cuda``); with no card it
fails rather than running on the CPU. ``--random_init`` (seed 0) is the only
model source for now: HF checkpoint loading, ``--long_files chunk``, the
turbo preset, ``--verify_model`` and the multi-device flags raise. As in the
reference, every clip is padded or trimmed to 30 s, the one decoder step
uses token id 0, and a run always resumes from the latest checkpoint.
"""

from __future__ import annotations

import argparse
import logging
import sys

# substring of --model_name -> WhisperConfig preset, first match wins (the JAX CLI's)
WHISPER_SIZES = (
    ("large-v3", "large_v3"), ("large-v2", "large_v2"), ("large", "large"),
    ("medium", "medium"), ("small", "small"), ("base", "base"),
    ("tiny", "tiny_official"),
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Extract Whisper encoder+decoder embeddings (PyTorch/CUDA)")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--model_name", type=str, default="openai/whisper-large",
                        help="Whisper model name (any size)")
    parser.add_argument("--model_path", type=str, default=None,
                        help="Local checkpoint directory (not supported yet)")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Clips per device batch (30 s mel each)")
    parser.add_argument("--split", type=str, default="all",
                        choices=["train", "test", "devel", "all"])
    parser.add_argument("--checkpoint_interval", type=int, default=50)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--random_init", action="store_true",
                        help="Random weights from seed 0 (no checkpoint load)")
    parser.add_argument("--long_files", type=str, default="trim", choices=["trim", "chunk"],
                        help="Files longer than 30 s: trim (chunk is not ported)")
    parser.add_argument("--verify_model", action="store_true",
                        help="Dummy-forward model verification (not ported)")
    parser.add_argument("--devices", type=int, default=None,
                        help="Number of devices (only 1 is supported)")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel size (only 1 is supported)")
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"],
                        help="Numerics preset: fast=bf16, fidelity=f32 without TF32 "
                             "(turbo is not ported)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def _check_supported(args) -> None:
    if not args.random_init:
        raise NotImplementedError(
            "loading HF checkpoints is not ported yet (ROADMAP Queue 1, HF checkpoint "
            "loading); pass --random_init")
    if args.long_files != "trim":
        raise NotImplementedError(
            "--long_files chunk is not ported yet (ROADMAP Queue 1, the chunk "
            "long-file policy)")
    if args.preset == "turbo":
        raise NotImplementedError(
            "the turbo preset is not ported yet (ROADMAP Queue 1, presets turbo and turbo_ffn)")
    if args.verify_model:
        raise NotImplementedError("--verify_model is not ported yet")
    if (args.devices or 1) != 1 or args.tp != 1:
        raise NotImplementedError(
            "multi-device runs are not ported yet (ROADMAP Queue 1, multi-GPU)")


def main(argv=None) -> int:
    args = parse_args(argv)
    _check_supported(args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    logger = logging.getLogger("stutter_tpu_torch.cli.extract_whisper")

    import torch

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import (
        ExtractionPipeline, WhisperExtractor, resolve_device)
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.models.whisper import WhisperConfig
    from stutter_tpu_torch.weights.convert import init_whisper

    device = resolve_device(args.device)
    size = next((p for key, p in WHISPER_SIZES if key in args.model_name), "base")
    cfg = getattr(WhisperConfig, size)()
    logger.warning("--random_init: using fresh whisper %s weights (seed 0, no checkpoint "
                   "load)", size)
    model = init_whisper(cfg, torch.Generator().manual_seed(0))
    logger.info("model: %s (%d enc / %d dec layers, d_model %d) on %s, preset %s",
                args.model_name, cfg.encoder_layers, cfg.decoder_layers, cfg.d_model,
                device, args.preset)

    metadata = create_metadata_from_files(args.data_dir, split=args.split)
    if not metadata:
        logger.error("no files found under %s", args.data_dir)
        return 1
    extractor = WhisperExtractor(model, device, preset=args.preset)
    batcher = BucketBatcher(
        target_sr=args.sample_rate,
        buckets_s=(30.0,),  # whisper contract: 30 s pad/trim
        audio_budget_s=30.0 * args.batch_size,
        max_batch=args.batch_size,
    )
    pipe = ExtractionPipeline(extractor, batcher=batcher,
                              checkpoint_interval=args.checkpoint_interval)
    splits = [args.split] if args.split != "all" else ["train", "test", "devel"]
    # the whisper reference resumes unconditionally
    pipe.run(metadata, args.output_dir, splits=splits, resume=True)
    logger.info("extraction complete -> %s", args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
