"""Model-identity checks before extraction (counterpart of ``stutter_tpu/models/verify.py``).

``verify_wavlm`` and ``verify_whisper`` run a dummy forward on the model's
device (WavLM: 1 s of silence; Whisper: a zero 3000-frame mel and one
decoder step) and check the hidden size against the checkpoint family named
(768 base, 1024 wavlm-large, 1280 whisper-large) and against the config, as
the reference's ``verify_model_loading`` does. A mismatch raises ValueError.
"""

from __future__ import annotations

import logging

import torch

from stutter_tpu_torch.models.wavlm import WavLMModel
from stutter_tpu_torch.models.whisper import WhisperModel

logger = logging.getLogger("stutter_tpu_torch.models.verify")


def _device_dtype(model: torch.nn.Module) -> tuple[torch.device, torch.dtype]:
    p = next(model.parameters())
    return p.device, p.dtype


def verify_wavlm(model: WavLMModel, model_name: str = "") -> int:
    """Dummy forward; returns the number of hidden states. Raises on a
    mismatch."""
    device, _ = _device_dtype(model)
    dummy = torch.zeros((1, 16000), dtype=torch.float32, device=device)  # 1 s of silence
    _, all_hidden, _ = model(dummy)
    n_states, _, frames, hidden = all_hidden.shape
    logger.info("WavLM verified: %d hidden states of [1, %d, %d]", n_states, frames, hidden)
    name = model_name.lower()
    if "large" in name and hidden != 1024:
        raise ValueError(f"requested large model but hidden size is {hidden}, not 1024")
    if ("base" in name and "large" not in name) and hidden != 768:
        raise ValueError(f"requested base model but hidden size is {hidden}, not 768")
    if hidden != model.cfg.hidden_size:
        raise ValueError(f"hidden size {hidden} != config {model.cfg.hidden_size}")
    return int(n_states)


def verify_whisper(model: WhisperModel, model_name: str = "") -> tuple[int, int]:
    """Dummy mel forward; returns (encoder states, decoder states)."""
    device, dtype = _device_dtype(model)
    cfg = model.cfg
    dummy = torch.zeros((1, cfg.num_mel_bins, 3000), dtype=dtype, device=device)
    enc_last, enc_states, _, dec_states = model(dummy)
    hidden = enc_last.shape[-1]
    logger.info("Whisper verified: %d encoder / %d decoder hidden states, d_model %d",
                enc_states.shape[0], dec_states.shape[0], hidden)
    if "large" in model_name.lower() and hidden != 1280:
        raise ValueError(f"requested large model but d_model is {hidden}, not 1280")
    if hidden != cfg.d_model:
        raise ValueError(f"d_model {hidden} != config {cfg.d_model}")
    return int(enc_states.shape[0]), int(dec_states.shape[0])
