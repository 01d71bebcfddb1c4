"""wav2vec 2.0 / XLS-R embedding extraction CLI on one GPU (``extract_wavlm``'s flags).

    python -m stutter_tpu_torch.cli.extract_wav2vec2 --data_dir <corpus> \\
        --output_dir <out> --model_path <local HF checkpoint dir> \\
        [--preset fast|fidelity|turbo] [--long_files trim|chunk] [--device cuda]

The weights come from a local HF checkpoint directory (``--model_path``, or
``--model_name`` naming one: ``Wav2Vec2Model``, ``Wav2Vec2ForPreTraining`` or
a task model), or with ``--random_init`` from seed 0 in the architecture
``--model_name`` names (XLS-R 2B or 300M, the widths whose heads the
attention kernel is built at); a hub name raises ``OSError`` (no download),
and a checkpoint whose heads the kernel lacks raises ``ValueError`` on a
card before its weights load. The store, its columns (states N, N - 1, N - 2
and N // 2 of the N + 1 hidden states), the checkpoints and the batcher's
defaults are ``extract_wavlm``'s. ``--device`` names the torch device
(default ``cuda``); with no card it fails rather than running on the CPU.
One device only: ``--devices`` above 1 raises. ``parse_args`` and ``run``
serve ``extract_w2v_bert`` too.
"""

from __future__ import annotations

import argparse
import sys

from stutter_tpu_torch.cli.common import WAV2VEC2_CONFIGS
from stutter_tpu_torch.utils.logging import get_logger, setup_logging


def parse_args(argv=None, model: str = "wav2vec 2.0 / XLS-R",
               model_name: str = "facebook/wav2vec2-xls-r-2b",
               choices=tuple(sorted(WAV2VEC2_CONFIGS))):
    """The flags; ``extract_w2v_bert`` takes them with its model's name and
    default, and any ``--model_name`` (``choices`` None)."""
    parser = argparse.ArgumentParser(
        description=f"Extract {model} embeddings for stuttering classification (PyTorch/CUDA)")
    parser.add_argument("--data_dir", type=str, required=True,
                        help="Base directory with KSF data (wav/ and lab/ subdirectories)")
    parser.add_argument("--output_dir", type=str, required=True,
                        help="Directory to save embeddings")
    parser.add_argument("--model_name", type=str, default=model_name, choices=choices,
                        help="model name")
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
    parser.add_argument("--devices", type=int, default=1,
                        help="Number of processes, one per card (1: this CLI runs on one)")
    parser.add_argument("--preset", type=str, default="fast",
                        choices=["fast", "fidelity", "turbo"],
                        help="Numerics preset: fast=bf16, fidelity=f32 without TF32, "
                             "turbo=fast with int8 W8A8 products")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    from stutter_tpu_torch.cli.common import load_wav2vec2_model
    from stutter_tpu_torch.extract.pipeline import Wav2Vec2Extractor

    return run(parse_args(argv), "wav2vec2", load_wav2vec2_model, Wav2Vec2Extractor)


def run(args, family: str, load_model, extractor_cls) -> int:
    """One device's extraction over ``args``' corpus: the model from
    ``load_model(name, random_init, device)``, the extractor
    ``extractor_cls``; the logfile ``{family}_embedding_*.log``."""
    if args.devices != 1:
        raise SystemExit(f"--devices {args.devices}: {family} extraction runs on one device "
                         "(no data or tensor parallelism for this model)")
    setup_logging(f"{family}_embedding")
    logger = get_logger(f"cli.extract_{family}")

    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    cfg, model = load_model(args.model_path or args.model_name, args.random_init, args.device)
    logger.info("model: %s (%d layers, hidden %d, %d heads of %d) on %s, preset %s",
                args.model_name, cfg.num_hidden_layers, cfg.hidden_size,
                cfg.num_attention_heads, cfg.head_dim, args.device, args.preset)

    metadata = create_metadata_from_files(args.data_dir, split=args.split)
    if not metadata:
        logger.error("no files found under %s", args.data_dir)
        return 1
    extractor = extractor_cls(model, args.device, preset=args.preset)
    batcher = BucketBatcher(
        target_sr=args.sample_rate,
        audio_budget_s=args.audio_budget,
        max_batch=args.batch_size,
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
