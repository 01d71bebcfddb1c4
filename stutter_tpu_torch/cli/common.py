"""What the port's CLIs share (counterpart of ``stutter_tpu/cli/common.py``, one device).

``load_wavlm_model`` and ``load_whisper_model`` give (config, float32
model): with ``random_init`` the architecture named by ``model_name`` with
seeded random weights (seed 0), else the local HF checkpoint directory
``model_name`` through ``weights.convert.load_wavlm`` / ``load_whisper``. A
hub name raises ``OSError``: this package never downloads.
``make_bucket_batcher`` builds the serve and predict CLIs' batcher from the
extractor's preferences; ``check_single_device`` refuses the multi-device
flags.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("stutter_tpu_torch.cli")

WAVLM_CONFIGS = {
    "microsoft/wavlm-base": "base",
    "microsoft/wavlm-base-plus": "base_plus",
    "microsoft/wavlm-large": "large",
    "microsoft/wavlm-large-v2": "large",
}

# substring of a Whisper name -> WhisperConfig preset, first match wins (the JAX CLI's)
WHISPER_SIZES = (
    ("large-v3", "large_v3"), ("large-v2", "large_v2"), ("large", "large"),
    ("medium", "medium"), ("small", "small"), ("base", "base"),
    ("tiny", "tiny_official"),
)


def check_single_device(args) -> None:
    """``--devices``/``--tp`` above 1 raise: one card only for now."""
    if (getattr(args, "devices", None) or 1) != 1 or getattr(args, "tp", 1) != 1:
        raise NotImplementedError(
            "multi-device runs are not ported yet (ROADMAP Queue 1, multi-GPU)")


def default_model_name(model_type: str, model_name: str | None) -> str:
    """The per-backbone default checkpoint (shared by serve and predict)."""
    if model_name:
        return model_name
    return ("microsoft/wavlm-large"
            if "wavlm" in model_type or model_type == "combined"
            else "openai/whisper-large")


def make_bucket_batcher(extractor, *, buckets_s=None, audio_budget_s, max_batch,
                        max_length_s=None):
    """A ``BucketBatcher`` honouring the extractor: its ``preferred_buckets``
    unless the caller names buckets (Whisper pads every clip to 30 s, so more
    buckets would only repeat the same work), and its ``frame_align``."""
    from stutter_tpu_torch.extract.batcher import DEFAULT_BUCKETS_S, BucketBatcher

    return BucketBatcher(
        buckets_s=buckets_s or getattr(extractor, "preferred_buckets", None)
        or DEFAULT_BUCKETS_S,
        audio_budget_s=audio_budget_s,
        max_batch=max_batch,
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
