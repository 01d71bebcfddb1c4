"""Plain Whisper in float32 PyTorch: the reference that decides ``correct``.

Follows the published model (Radford et al. 2022, "Robust Speech
Recognition via Large-Scale Weak Supervision"; the layout of
openai/whisper-large's ``config.json`` and HF's ``WhisperFeatureExtractor``
and ``modeling_whisper.py``) as the extraction uses it:

- log-mel: the wave zero-padded (or cut) to 30 s; a periodic-Hann STFT of
  400 points every 160 samples, centred with reflection, its last frame
  dropped; the power spectrum times the slaney mel bank over 0-8 kHz;
  ``log10(max(., 1e-10))``, floored at the clip's max - 8, then (x + 4) / 4;
- encoder: two convolutions (k 3, padding 1, the second of stride 2) with
  GELU, plus the position table, then pre-LN layers (self-attention with
  no bias on k, then the FFN) and a final layer norm;
- decoder: one step of token id 0 at position 0 (the reference
  extraction's quirk): per pre-LN layer the token's self-attention (one key,
  so its own v), cross-attention over the encoder's last state, the FFN;
  then a final layer norm.

Hidden state i is the input of layer i; the last is the final norm's
output. The encoder's selected states are mean-pooled over all 1500 frames,
padding included, as the reference extraction pools them; the decoder's are
the token's. The mel bank is worked out here in float64. It takes the
weights by the names of the state dict the benchmark made and imports
nothing of the program. Call it under ``no_tf32``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, SR, N_SAMPLES = 400, 160, 16000, 480_000


def hz_to_mel(f):
    f = np.asarray(f, np.float64)
    with np.errstate(divide="ignore"):
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-12) / 1000.0) * 27.0
                        / np.log(6.4), 3.0 * f / 200.0)


def mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0), 200.0 * m / 3.0)


def mel_bank(n_mels: int) -> np.ndarray:
    """[201, n_mels] slaney-scale, slaney-normalised triangular filters."""
    fft_hz = np.linspace(0.0, SR / 2, N_FFT // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SR / 2), n_mels + 2))
    lower = (fft_hz[:, None] - pts[None, :-2]) / (pts[1:-1] - pts[:-2])
    upper = (pts[None, 2:] - fft_hz[:, None]) / (pts[2:] - pts[1:-1])
    bank = np.maximum(0.0, np.minimum(lower, upper))
    return bank * (2.0 / (pts[2:] - pts[:-2]))[None, :]


def log_mel(wave: torch.Tensor, n_mels: int) -> torch.Tensor:
    """[B, T] waves -> [B, n_mels, 3000] features."""
    wave = F.pad(wave, (0, max(0, N_SAMPLES - wave.shape[1])))[:, :N_SAMPLES]
    window = torch.hann_window(N_FFT, periodic=True, dtype=wave.dtype, device=wave.device)
    spec = torch.stft(wave, N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.abs() ** 2
    bank = torch.from_numpy(mel_bank(n_mels)).to(wave)
    mel = torch.log10(torch.clamp(bank.t() @ power, min=1e-10))
    mel = torch.maximum(mel, mel.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (mel + 4.0) / 4.0


def lin(x, w, b=None):
    """x w^T + b."""
    y = x @ w.t()
    return y if b is None else y + b


def layer_norm(x, W, name, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), W[name + "_s"], W[name + "_b"], eps)


def ffn(W, p, x):
    h = F.gelu(lin(x, W[p + "fc1_w"], W[p + "fc1_b"]))
    return lin(h, W[p + "fc2_w"], W[p + "fc2_b"])


def attend(W, p, x, mem, heads):
    """Attention of queries x [B, Lq, D] over mem [B, Lk, D]."""
    B, Lq, D = x.shape
    hd = D // heads

    def split(t):
        return t.view(B, -1, heads, hd).transpose(1, 2)

    q = split(lin(x, W[p + "q_w"], W[p + "q_b"]) * hd ** -0.5)
    k = split(lin(mem, W[p + "k_w"], None))
    v = split(lin(mem, W[p + "v_w"], W[p + "v_b"]))
    out = (torch.softmax(q @ k.transpose(2, 3), dim=-1) @ v).transpose(1, 2).reshape(B, Lq, D)
    return lin(out, W[p + "o_w"], W[p + "o_b"])


@torch.no_grad()
def pooled(cfg: dict, W: dict, waves: torch.Tensor, enc_layers, dec_layers) -> torch.Tensor:
    """[len(enc_layers) + len(dec_layers), B, D]: the encoder's selected
    states mean-pooled over 1500 frames, then the decoder's at its token."""
    x = log_mel(waves, cfg["num_mel_bins"])
    x = F.gelu(F.conv1d(x, W["encoder.conv1_w"], W["encoder.conv1_b"], padding=1))
    x = F.gelu(F.conv1d(x, W["encoder.conv2_w"], W["encoder.conv2_b"], stride=2, padding=1))
    x = x.transpose(1, 2) + W["encoder.pos_embed"]
    H = cfg["encoder_attention_heads"]
    enc = []
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.layers.{i}."
        enc.append(x.mean(dim=1) if i in enc_layers else None)
        h = layer_norm(x, W, p + "ln1")
        x = x + attend(W, p + "attn.", h, h, H)
        x = x + ffn(W, p + "ffn.", layer_norm(x, W, p + "ln2"))
    x = layer_norm(x, W, "encoder.ln")
    enc.append(x.mean(dim=1))
    memory = x

    B = waves.shape[0]
    y = (W["decoder.embed_tokens"][0] + W["decoder.pos_embed"][0]).expand(B, 1, -1)
    H = cfg["decoder_attention_heads"]
    dec = []
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.layers.{i}."
        dec.append(y[:, 0])
        v = lin(layer_norm(y, W, p + "ln1"), W[p + "attn.v_w"], W[p + "attn.v_b"])
        y = y + lin(v, W[p + "attn.o_w"], W[p + "attn.o_b"])
        y = y + attend(W, p + "xattn.", layer_norm(y, W, p + "ln2"), memory, H)
        y = y + ffn(W, p + "ffn.", layer_norm(y, W, p + "ln3"))
    dec.append(layer_norm(y, W, "decoder.ln")[:, 0])
    return torch.stack([enc[i] for i in enc_layers] + [dec[i] for i in dec_layers])
