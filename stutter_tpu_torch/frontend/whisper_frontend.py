"""Whisper input frontend: pad/trim to 30 s, then the batched log-mel.

Counterpart of ``stutter_tpu/frontend/whisper_frontend.py``. Zero padding to
480 000 samples is part of the contract: the encoder attends to the padded
mel, as the reference does. On the card the log-mel is the hand-written
kernel (``ops.logmel.whisper_log_mel``); on the CPU its plain version.
"""

from __future__ import annotations

import torch

from stutter_tpu_torch.ops.logmel import WHISPER_N_SAMPLES, pad_or_trim, whisper_log_mel


def whisper_features(waveform: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """[B, T] float32 (any T) -> [B, n_mels, 3000] Whisper input features.

    n_mels is 80 for whisper tiny..large-v2, 128 for large-v3."""
    return whisper_log_mel(pad_or_trim(waveform.float(), WHISPER_N_SAMPLES), n_mels=n_mels)
