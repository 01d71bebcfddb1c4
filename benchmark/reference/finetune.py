"""Plain WavLM fine-tuning in float32 PyTorch: the reference of the
fine-tune cell's first updates.

The fine-tuning recipe of the reference package (``stutter_tpu/train/
finetune.py``, which the configuration follows): every hidden state of the
WavLM backbone (``reference.wavlm``) mean-pooled over the clip's frames,
their softmax-weighted sum (``layer_weights``), an MLP head (dense layers
with GELU's tanh form and dropout between them; weights [in, out]), the
class-weighted cross-entropy as the weighted mean over the batch's valid
rows, with sklearn's "balanced" class weights over the train labels; the
feature encoder frozen; AdamW as optax's ``adamw`` (decay on every trained
parameter), the backbone and the head at their own learning rates.

SpecAugment and dropout draw from a generator seeded as the recipe seeds
it, on the card, in the recipe's order each update: the time-mask span
starts over the padded batch ([B, L] uniforms under prob / span; a start
masks itself and the span - 1 frames after it, cut to each clip's frames,
filled with ``masked_spec_embed``), then the dropout keep mask of the
head's hidden layer ([B, hidden] uniforms under 1 - p). So the reference
works the masks out again from the seed. Each clip runs alone (no padding,
no masks), its loss weighted by its class weight over the batch's weight
mass; gradients add up over the clips. Call it under ``no_tf32``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import wavlm as backbone


def class_weights(labels: np.ndarray, n_classes: int) -> np.ndarray:
    """sklearn's "balanced": n / (classes present * count), 0 where absent."""
    counts = np.bincount(labels, minlength=n_classes).astype(np.float64)
    out = np.zeros(n_classes)
    out[counts > 0] = len(labels) / ((counts > 0).sum() * counts[counts > 0])
    return out


def span_mask(gen: torch.Generator, shape, prob: float, span: int) -> torch.Tensor:
    """[B, L] bool: frame t is masked when a span starts in t - span + 1 .. t."""
    starts = torch.rand(shape, generator=gen, device=gen.device) < prob / span
    masked = torch.zeros_like(starts)
    for k in range(span):
        masked[:, k:] |= starts[:, : starts.shape[1] - k]
    return masked


def head(W: dict, x: torch.Tensor, keep: torch.Tensor | None, p: float) -> torch.Tensor:
    """Logits of the MLP head for one clip's pooled features [D]."""
    n = len([k for k in W if k.startswith("head.layers.") and k.endswith(".w")])
    for i in range(n):
        x = x @ W[f"head.layers.{i}.w"] + W[f"head.layers.{i}.b"]
        if i < n - 1:
            x = F.gelu(x, approximate="tanh")
            if keep is not None:
                x = torch.where(keep, x / (1.0 - p), 0.0)
    return x


def strip(W: dict) -> dict:
    """The backbone's weights under the backbone's own names."""
    return {k[len("backbone."):]: v for k, v in W.items() if k.startswith("backbone.")}


def gradients(cfg: dict, recipe: dict, W: dict, trained: list[str], batch, cw: np.ndarray,
              gen: torch.Generator) -> tuple[float, dict[str, torch.Tensor]]:
    """(loss, {leaf: gradient}) of one update's batch; W's ``trained`` leaves
    require grad. ``batch`` is (clips, (B, T), labels [B], valid [B]): the
    samples of each row's clip (None for a pad row) and the padded shape the
    recipe's batch has, whose frames the masks are drawn over."""
    clips, (B, T), labels, valid = batch
    frames = backbone_frames(cfg, T)
    tmask = (span_mask(gen, (B, frames), cfg["mask_time_prob"], cfg["mask_time_length"])
             if cfg.get("apply_spec_augment", True) and cfg["mask_time_prob"] > 0 else None)
    p = recipe["head_dropout"]
    keep = (torch.rand((B, recipe["head_hidden"][-1]), generator=gen, device=gen.device)
            < 1.0 - p) if p > 0 else None
    w = cw[labels] * valid
    mass = w.sum()
    bb = strip(W)
    for name in trained:
        W[name].grad = None
    loss = 0.0
    for i in np.flatnonzero(w > 0):
        n = min(len(clips[i]), T)
        wave = torch.from_numpy(clips[i][:n]).to(gen.device)
        L = backbone_frames(cfg, n)
        states = backbone.hidden_states(cfg, bb, wave, None if tmask is None else tmask[i, :L],
                                        frozen_stem=True)
        pooled = torch.stack([s.mean(dim=0) for s in states])
        x = torch.softmax(W["layer_weights"], dim=0) @ pooled
        logits = head(W, x, None if keep is None else keep[i], p)
        nll = -torch.log_softmax(logits, dim=-1)[int(labels[i])]
        (nll * float(w[i] / mass)).backward()
        loss += float(nll.detach()) * float(w[i] / mass)
    return loss, {name: W[name].grad.detach().clone() for name in trained}


def backbone_frames(cfg: dict, n_samples: int) -> int:
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n_samples = (n_samples - k) // s + 1
    return n_samples


class AdamW:
    """optax's ``adamw`` in float32, one learning rate a leaf, from step
    ``t`` with moments ``mu`` and ``nu`` (a fresh optimizer by default)."""

    def __init__(self, lrs: dict[str, float], weight_decay: float, b1=0.9, b2=0.999, eps=1e-8,
                 t: int = 0, mu: dict | None = None, nu: dict | None = None):
        self.lrs, self.wd, self.b1, self.b2, self.eps = lrs, weight_decay, b1, b2, eps
        self.t, self.mu, self.nu = t, dict(mu or {}), dict(nu or {})

    @torch.no_grad()
    def step(self, W: dict, grads: dict) -> None:
        self.t += 1
        for name, g in grads.items():
            mu = self.mu.get(name, torch.zeros_like(g)) * self.b1 + (1 - self.b1) * g
            nu = self.nu.get(name, torch.zeros_like(g)) * self.b2 + (1 - self.b2) * g * g
            self.mu[name], self.nu[name] = mu, nu
            u = (mu / (1 - self.b1 ** self.t)) / (torch.sqrt(nu / (1 - self.b2 ** self.t))
                                                   + self.eps)
            W[name] -= self.lrs[name] * (u + self.wd * W[name])
