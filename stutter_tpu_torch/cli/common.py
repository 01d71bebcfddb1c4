"""What the port's CLIs share (counterpart of ``stutter_tpu/cli/common.py``).

``load_wavlm_model``, ``load_wav2vec2_model`` and ``load_whisper_model``
give (config, float32 model): with ``random_init`` the architecture named by
``model_name`` with seeded random weights (seed 0), else the local HF
checkpoint directory ``model_name`` through ``weights.convert.load_wavlm`` /
``load_wav2vec2`` / ``load_whisper``. A
hub name raises ``OSError``: this package never downloads.
``make_bucket_batcher`` builds the serve and predict CLIs' batcher from the
extractor's preferences and the plan's data size.

``add_mesh_args`` adds ``--devices N`` and ``--tp T`` to every CLI that runs
a model (extraction, fine-tuning, serving, prediction, the downstream
trainers): ``run_on_devices`` spawns N worker processes, one per card, each
running the CLI again in one process group, unless this process is already
one of them (spawned here or by ``torchrun``); ``build_plan`` then gives the
rank its [N / T, T] plan, or None on one device, where no group is started.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

logger = logging.getLogger("stutter_tpu_torch.cli")

WAVLM_CONFIGS = {
    "microsoft/wavlm-base": "base",
    "microsoft/wavlm-base-plus": "base_plus",
    "microsoft/wavlm-large": "large",
    "microsoft/wavlm-large-v2": "large",
}

WAV2VEC2_CONFIGS = {
    "facebook/wav2vec2-xls-r-2b": "xls_r_2b",
    "facebook/wav2vec2-xls-r-300m": "xls_r_300m",
}

# substring of a Whisper name -> WhisperConfig preset, first match wins (the JAX CLI's)
WHISPER_SIZES = (
    ("large-v3", "large_v3"), ("large-v2", "large_v2"), ("large", "large"),
    ("medium", "medium"), ("small", "small"), ("base", "base"),
    ("tiny", "tiny_official"),
)


def add_mesh_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--devices", type=int, nargs="?", default=None, const=None,
                        help="Number of processes, one per card (default, or the flag "
                             "alone: every visible card; 1 with --device cpu)")
    parser.add_argument("--tp", type=int, default=1,
                        help="Tensor-parallel size (model axis); devices/tp is the "
                             "data-parallel size")


def _in_group() -> bool:
    import torch.distributed as dist

    return dist.is_initialized() or "RANK" in os.environ


def rank_count(args) -> int:
    """The processes a run asks for: ``--devices``, else every visible card
    (one with ``--device cpu``)."""
    if args.devices is not None:
        if args.devices < 1:
            raise ValueError(f"--devices must be at least 1, got {args.devices}")
        return args.devices
    import torch

    return max(1, torch.cuda.device_count()) if args.device.startswith("cuda") else 1


def run_on_devices(module: str, argv, args, store_dir: str) -> int | None:
    """Spawn the CLI's ranks when the run asks for more than one process and
    this process is not already a rank: returns the exit code once they are
    done, else None (the caller runs on). The layout is checked first, so a
    bad ``--tp`` fails here and not in every worker."""
    from stutter_tpu_torch.parallel.mesh import plan_shape, spawn_cli

    if _in_group():
        return None
    n = rank_count(args)
    plan_shape(n, model=args.tp)
    if n == 1:
        return None
    logger.info("spawning %d ranks (data %d x model %d)", n, n // args.tp, args.tp)
    return spawn_cli(module, sys.argv[1:] if argv is None else list(argv), n,
                     "cuda" if args.device.startswith("cuda") else "cpu", store_dir)


def build_plan(args):
    """This rank's ``MeshPlan`` ([devices / tp, tp]), joining ``torchrun``'s
    group if this process was started by it; None on one device."""
    import torch.distributed as dist

    from stutter_tpu_torch.parallel.mesh import init_distributed, make_plan

    if "RANK" in os.environ and not dist.is_initialized():
        init_distributed(backend="nccl" if args.device.startswith("cuda") else "gloo")
    if not dist.is_initialized():
        return None
    return make_plan(model=args.tp)


def rank_device(args, plan):
    """The torch device of this rank: under a plan on cards, the card the
    launcher gave it (``--device``'s index is for one device)."""
    import torch

    from stutter_tpu_torch.extract.pipeline import resolve_device

    device = resolve_device(args.device)
    if plan is not None and device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def default_model_name(model_type: str, model_name: str | None) -> str:
    """The per-backbone default checkpoint (shared by serve and predict)."""
    if model_name:
        return model_name
    return ("microsoft/wavlm-large"
            if "wavlm" in model_type or model_type == "combined"
            else "openai/whisper-large")


def make_bucket_batcher(extractor, plan, *, buckets_s=None, audio_budget_s, max_batch,
                        max_length_s=None):
    """A ``BucketBatcher`` honouring the extractor: its ``preferred_buckets``
    unless the caller names buckets (Whisper pads every clip to 30 s, so more
    buckets would only repeat the same work), and its ``frame_align``; every
    batch a multiple of the plan's data size, so that it splits over the
    data ranks."""
    from stutter_tpu_torch.extract.batcher import DEFAULT_BUCKETS_S, BucketBatcher

    return BucketBatcher(
        buckets_s=buckets_s or getattr(extractor, "preferred_buckets", None)
        or DEFAULT_BUCKETS_S,
        audio_budget_s=audio_budget_s,
        max_batch=max_batch,
        batch_multiple=plan.data_size if plan else 1,
        max_length_s=max_length_s,
        frame_align=getattr(extractor, "frame_align", None),
    )


def load_wavlm_model(model_name: str, random_init: bool):
    """(WavLMConfig, float32 WavLMModel on the CPU)."""
    import torch

    from stutter_tpu_torch.models.wavlm import WavLMConfig
    from stutter_tpu_torch.weights.convert import init_wavlm, load_wavlm

    if random_init:
        preset = WAVLM_CONFIGS.get(model_name, "base")
        cfg = getattr(WavLMConfig, preset)()
        logger.warning("--random_init: using fresh %s weights (seed 0, no checkpoint load)",
                       preset)
        return cfg, init_wavlm(cfg, torch.Generator().manual_seed(0))
    return load_wavlm(model_name)


def load_wav2vec2_model(model_name: str, random_init: bool, device: str = "cpu"):
    """(Wav2Vec2Config, float32 Wav2Vec2Model on the CPU). Raises ValueError,
    before any weight loads, for heads that ``device`` cannot run
    (``Wav2Vec2Extractor.check_device``)."""
    import torch

    from stutter_tpu_torch.extract.pipeline import Wav2Vec2Extractor
    from stutter_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from stutter_tpu_torch.weights.convert import init_wav2vec2, load_wav2vec2, wav2vec2_config

    if random_init:
        preset = WAV2VEC2_CONFIGS.get(model_name, "xls_r_2b")
        cfg = getattr(Wav2Vec2Config, preset)()
        Wav2Vec2Extractor.check_device(cfg, device)
        logger.warning("--random_init: using fresh wav2vec2 %s weights (seed 0)", preset)
        return cfg, init_wav2vec2(cfg, torch.Generator().manual_seed(0))
    Wav2Vec2Extractor.check_device(wav2vec2_config(model_name), device)
    return load_wav2vec2(model_name)


def load_w2v_bert_model(model_name: str, random_init: bool, device: str = "cpu"):
    """(W2VBertConfig, float32 W2VBertModel on the CPU, the published
    weights unfolded). Raises ValueError, before any weight loads, for heads
    that ``device`` cannot run (``W2VBertExtractor.check_device``)."""
    import torch

    from stutter_tpu_torch.extract.pipeline import W2VBertExtractor
    from stutter_tpu_torch.models.w2v_bert import W2VBertConfig
    from stutter_tpu_torch.weights.convert import init_w2v_bert, load_w2v_bert, w2v_bert_config

    if random_init:
        cfg = W2VBertConfig.w2v_bert_2_0()
        logger.warning("--random_init: using fresh w2v-BERT 2.0 weights (seed 0)")
        return cfg, init_w2v_bert(cfg, torch.Generator().manual_seed(0))
    W2VBertExtractor.check_device(w2v_bert_config(model_name), device)
    return load_w2v_bert(model_name)


def load_whisper_model(model_name: str, random_init: bool):
    """(WhisperConfig, float32 WhisperModel on the CPU)."""
    import torch

    from stutter_tpu_torch.models.whisper import WhisperConfig
    from stutter_tpu_torch.weights.convert import init_whisper, load_whisper

    if random_init:
        preset = next((p for key, p in WHISPER_SIZES if key in model_name), "base")
        cfg = getattr(WhisperConfig, preset)()
        logger.warning("--random_init: using fresh whisper %s weights (seed 0)", preset)
        return cfg, init_whisper(cfg, torch.Generator().manual_seed(0))
    return load_whisper(model_name)
