"""WavLM embedding extraction CLI on one GPU (flags of ``stutter_tpu.cli.extract_wavlm``).

    python -m stutter_tpu_torch.cli.extract_wavlm --data_dir <corpus> \\
        --output_dir <out> --random_init [--preset fast|fidelity|turbo] [--device cuda]

``--device`` names the torch device (default ``cuda``); with no card it
fails rather than running on the CPU. ``--random_init`` (seed 0) is the only
model source for now: HF checkpoint loading, ``--long_files chunk``,
``--verify_model`` and the multi-device flags raise. ``--preset`` takes the
JAX CLI's three: fast (bf16), fidelity (f32, no TF32) and turbo (fast with
int8 projections). The JAX package's environment switch for WavLM's long
buckets is read here, once: a non-empty ``STUTTER_TPU_LONG_ATTENTION_FLASH``
sends bf16 attention from ``STUTTER_TPU_LONG_ATTENTION_MIN_L`` frames
(default 1008) up through the materialised-bias flash kernel
(``WavLMExtractor(long_attention="materialized_bias")``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

WAVLM_CONFIGS = {
    "microsoft/wavlm-base": "base",
    "microsoft/wavlm-base-plus": "base_plus",
    "microsoft/wavlm-large": "large",
    "microsoft/wavlm-large-v2": "large",
}


def long_attention_from_env(environ=None) -> dict:
    """``WavLMExtractor``'s ``long_attention`` (and ``long_min_l``, where it is
    set) from the JAX package's switch, read as that package reads it
    (``stutter_tpu/models/wavlm.py:409-463``)."""
    env = os.environ if environ is None else environ
    out = {"long_attention": ("materialized_bias" if env.get("STUTTER_TPU_LONG_ATTENTION_FLASH")
                              else "gated")}
    if env.get("STUTTER_TPU_LONG_ATTENTION_MIN_L"):
        out["long_min_l"] = int(env["STUTTER_TPU_LONG_ATTENTION_MIN_L"])
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Extract WavLM embeddings for stuttering classification (PyTorch/CUDA)")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="Base directory with KSF data (wav/ and lab/ subdirectories)")
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Directory to save embeddings")
    parser.add_argument("--model_name", type=str, default="microsoft/wavlm-large",
                        choices=sorted(WAVLM_CONFIGS), help="WavLM model name")
    parser.add_argument("--model_path", type=str, default=None,
                        help="Local checkpoint directory (not supported yet)")
    parser.add_argument("--batch_size", type=int, default=128,
                        help="Max clips per device batch")
    parser.add_argument("--split", type=str, default="all",
                        choices=["train", "test", "devel", "all"])
    parser.add_argument("--checkpoint_interval", type=int, default=50,
                        help="Save a resume checkpoint every N files")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from latest checkpoint")
    parser.add_argument("--max_length", type=float, default=None,
                        help="Maximum audio length in seconds (longer files trimmed)")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--audio_budget", type=float, default=240.0,
                        help="Audio seconds per device batch")
    parser.add_argument("--random_init", action="store_true",
                        help="Random weights from seed 0 (no checkpoint load)")
    parser.add_argument("--long_files", type=str, default="trim", choices=["trim", "chunk"],
                        help="Files longer than the top bucket: trim (chunk is not ported)")
    parser.add_argument("--verify_model", action="store_true",
                        help="Dummy-forward model verification (not ported)")
    parser.add_argument("--devices", type=int, default=None,
                        help="Number of devices (only 1 is supported)")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel size (only 1 is supported)")
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"],
                        help="Numerics preset: fast=bf16, fidelity=f32 without TF32, "
                             "turbo=fast with int8 W8A8 projections")
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
    logger = logging.getLogger("stutter_tpu_torch.cli.extract_wavlm")

    import torch

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import (
        ExtractionPipeline, WavLMExtractor, resolve_device)
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.models.wavlm import WavLMConfig
    from stutter_tpu_torch.weights.convert import init_wavlm

    device = resolve_device(args.device)
    cfg = getattr(WavLMConfig, WAVLM_CONFIGS[args.model_name])()
    logger.warning("--random_init: using fresh %s weights (seed 0, no checkpoint load)",
                   args.model_name)
    model = init_wavlm(cfg, torch.Generator().manual_seed(0))
    logger.info("model: %s (%d layers, hidden %d, stable_ln=%s) on %s, preset %s",
                args.model_name, cfg.num_hidden_layers, cfg.hidden_size,
                cfg.do_stable_layer_norm, device, args.preset)

    metadata = create_metadata_from_files(args.data_dir, split=args.split)
    if not metadata:
        logger.error("no files found under %s", args.data_dir)
        return 1
    extractor = WavLMExtractor(model, device, preset=args.preset, **long_attention_from_env())
    batcher = BucketBatcher(
        target_sr=args.sample_rate,
        audio_budget_s=args.audio_budget,
        max_batch=args.batch_size,
        max_length_s=args.max_length,
        frame_align=extractor.frame_align,
    )
    pipe = ExtractionPipeline(extractor, batcher=batcher,
                              checkpoint_interval=args.checkpoint_interval)
    splits = [args.split] if args.split != "all" else ["train", "test", "devel"]
    pipe.run(metadata, args.output_dir, splits=splits, resume=args.resume)
    logger.info("extraction complete -> %s", args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
