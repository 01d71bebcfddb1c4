"""WavLM embedding extraction CLI on one or many GPUs (flags of ``stutter_tpu.cli.extract_wavlm``).

    python -m stutter_tpu_torch.cli.extract_wavlm --data_dir <corpus> \\
        --output_dir <out> --model_path <local HF checkpoint dir> \\
        [--preset fast|fidelity|turbo] [--long_files trim|chunk] [--verify_model] \\
        [--devices N [--tp T]] [--device cuda]

``--device`` names the torch device (default ``cuda``); with no card it
fails rather than running on the CPU. The weights come from a local HF
checkpoint directory (``--model_path``, or ``--model_name`` naming one), or
with ``--random_init`` from seed 0 in the architecture ``--model_name``
names; a hub name raises ``OSError`` (no download). ``--verify_model`` runs
the dummy-forward check first; ``--long_files chunk`` embeds files longer
than the top bucket as length-weighted chunks. ``--devices N`` runs N
processes, one per card (default: every visible card), ``--tp T`` cuts the
model over T of them and splits the batches over N / T
(``cli.common.run_on_devices``); under ``torchrun`` the CLI joins its group.
``--preset`` takes the JAX CLI's three: fast (bf16), fidelity (f32,
no TF32) and turbo (fast with int8 projections). The JAX package's
environment switch for WavLM's long buckets is read here, once: a non-empty
``STUTTER_TPU_LONG_ATTENTION_FLASH`` sends bf16 attention from
``STUTTER_TPU_LONG_ATTENTION_MIN_L`` frames (default 1008) up through the
materialised-bias flash kernel
(``WavLMExtractor(long_attention="materialized_bias")``).
"""

from __future__ import annotations

import argparse
import os
import sys

from stutter_tpu_torch.cli.common import (
    WAVLM_CONFIGS,
    add_mesh_args,
    build_plan,
    rank_device,
    run_on_devices,
)
from stutter_tpu_torch.utils.logging import get_logger, setup_logging


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
                        help="Local checkpoint directory (overrides --model_name source)")
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
                        help="Files longer than the top bucket: trim (reference "
                             "behavior) or chunk+weighted-average")
    parser.add_argument("--verify_model", action="store_true",
                        help="Dummy-forward model verification before extraction")
    add_mesh_args(parser)
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"],
                        help="Numerics preset: fast=bf16, fidelity=f32 without TF32, "
                             "turbo=fast with int8 W8A8 projections")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    setup_logging("wavlm_embedding")
    logger = get_logger("cli.extract_wavlm")
    rc = run_on_devices("stutter_tpu_torch.cli.extract_wavlm", argv, args, args.output_dir)
    if rc is not None:
        return rc

    from stutter_tpu_torch.cli.common import load_wavlm_model
    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, WavLMExtractor
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    plan = build_plan(args)
    device = rank_device(args, plan)
    cfg, model = load_wavlm_model(args.model_path or args.model_name, args.random_init)
    logger.info("model: %s (%d layers, hidden %d, stable_ln=%s) on %s, preset %s",
                args.model_name, cfg.num_hidden_layers, cfg.hidden_size,
                cfg.do_stable_layer_norm, device, args.preset)

    metadata = create_metadata_from_files(args.data_dir, split=args.split)
    if not metadata:
        logger.error("no files found under %s", args.data_dir)
        return 1
    if args.verify_model:  # after the cheap metadata check
        from stutter_tpu_torch.models.verify import verify_wavlm

        verify_wavlm(model.to(device), model_name=args.model_path or args.model_name)
    extractor = WavLMExtractor(model, device, preset=args.preset, plan=plan,
                               **long_attention_from_env())
    batcher = BucketBatcher(
        target_sr=args.sample_rate,
        audio_budget_s=args.audio_budget,
        max_batch=args.batch_size,
        batch_multiple=plan.data_size if plan else 1,
        max_length_s=args.max_length,
        frame_align=extractor.frame_align,
    )
    pipe = ExtractionPipeline(extractor, batcher=batcher,
                              checkpoint_interval=args.checkpoint_interval,
                              long_file_policy=args.long_files)
    splits = [args.split] if args.split != "all" else ["train", "test", "devel"]
    pipe.run(metadata, args.output_dir, splits=splits, resume=args.resume)
    logger.info("extraction complete -> %s", args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
