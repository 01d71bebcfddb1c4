"""Classifier heads and their loss (counterpart of ``stutter_tpu/train/heads.py``).

An MLP on [B, D] features: dense layers with weights stored in the JAX
package's layout (``w`` [in, out], ``b`` [out]), so that the converter
copies them as they are; GELU between layers is ``jax.nn.gelu``'s default,
the tanh approximation, in f32; dropout draws its keep mask from a
``torch.Generator`` on the activations' device. An empty ``hidden_dims``
gives the linear (multinomial logistic) head. The class-weighted
cross-entropy keeps the JAX package's split into an un-normalised (loss
sum, weight mass) pair, so gradient accumulation normalises once; ``valid``
masks pad rows out of both.

The fine-tune trains the head inside ``train/finetune.py``; the downstream
classifier is ``HeadClassifier``, the counterpart of ``JaxClassifier``: an
sklearn-style fit/predict around the same loop as the JAX package's optax
loop, on one device. ``StandardScaler`` is sklearn's (float64 statistics,
ddof 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stutter_tpu_torch.train.class_weights import compute_class_weights
from stutter_tpu_torch.train.optim import MultiAdamW


class StandardScaler:
    """sklearn's zero-mean unit-std feature scaling (ddof 0; a std of 0
    scales by 1)."""

    def __init__(self):
        self.mean_: np.ndarray | None = None
        self.scale_: np.ndarray | None = None

    def fit(self, X: np.ndarray) -> "StandardScaler":
        X = np.asarray(X, np.float64)
        self.mean_ = X.mean(axis=0)
        std = X.std(axis=0)
        self.scale_ = np.where(std == 0.0, 1.0, std)
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return ((np.asarray(X, np.float64) - self.mean_) / self.scale_).astype(np.float32)

    def fit_transform(self, X: np.ndarray) -> np.ndarray:
        return self.fit(X).transform(X)


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    """The JAX package's ``HeadConfig``. The fine-tune head reads the first
    four fields; ``HeadClassifier`` reads them all."""

    in_dim: int
    n_classes: int
    hidden_dims: tuple[int, ...] = ()  # () = linear / logistic head
    dropout: float = 0.1
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    epochs: int = 200
    batch_size: int = 256
    label_smoothing: float = 0.0
    seed: int = 0


def init_head_params(cfg: HeadConfig, generator: torch.Generator) -> list[dict[str, torch.Tensor]]:
    """He-normal weights (normal * sqrt(2 / in)) and zero biases, layer by
    layer, f32 on the CPU: [{"w": [in, out], "b": [out]}, ...]."""
    dims = (cfg.in_dim, *cfg.hidden_dims, cfg.n_classes)
    return [{"w": torch.randn(din, dout, generator=generator) * np.sqrt(2.0 / din),
             "b": torch.zeros(dout)}
            for din, dout in zip(dims[:-1], dims[1:])]


class _Dense(nn.Module):
    def __init__(self, din: int, dout: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(din, dout, device=device))
        self.b = nn.Parameter(torch.empty(dout, device=device))


class MLPHead(nn.Module):
    """Dense layers in_dim -> hidden_dims... -> n_classes, f32."""

    def __init__(self, cfg: HeadConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dims = (cfg.in_dim, *cfg.hidden_dims, cfg.n_classes)
        self.layers = nn.ModuleList(_Dense(a, b, device) for a, b in zip(dims[:-1], dims[1:]))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "MLPHead":
        """``init_head_params``'s weights, drawn on the CPU."""
        return self.load_params(init_head_params(self.cfg, generator))

    @torch.no_grad()
    def load_params(self, params: list[dict]) -> "MLPHead":
        """Copy [{"w", "b"}, ...] (tensors or arrays) into the layers."""
        for layer, p in zip(self.layers, params, strict=True):
            layer.w.copy_(torch.as_tensor(np.asarray(p["w"])))
            layer.b.copy_(torch.as_tensor(np.asarray(p["b"])))
        return self

    def forward(self, x: torch.Tensor, dropout: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits for [B, D] features."""
        h = x
        for i, layer in enumerate(self.layers):
            h = h @ layer.w + layer.b
            if i < len(self.layers) - 1:
                h = F.gelu(h, approximate="tanh")
                if dropout > 0.0 and generator is not None:
                    keep = torch.rand(h.shape, generator=generator,
                                      device=h.device) < 1.0 - dropout
                    h = torch.where(keep, h / (1.0 - dropout), 0.0)
        return h


def weighted_xent_sums(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: torch.Tensor | None = None,
                       label_smoothing: float = 0.0,
                       valid: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(weighted loss SUM, weight mass): the un-normalised pair, so that
    microbatch sums add like one big batch."""
    n_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n_classes).float()
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n_classes
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_example = -(onehot * logp).sum(dim=-1)
    w = (class_weights.float()[labels.long()] if class_weights is not None
         else torch.ones_like(per_example))
    if valid is not None:
        w = w * valid.to(w.dtype)
    return (per_example * w).sum(), w.sum()


def weighted_softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                          class_weights: torch.Tensor | None = None,
                          label_smoothing: float = 0.0,
                          valid: torch.Tensor | None = None) -> torch.Tensor:
    """Class-weighted CE, the weighted mean over ``valid`` rows."""
    loss_sum, w_sum = weighted_xent_sums(logits, labels, class_weights, label_smoothing,
                                         valid)
    return loss_sum / torch.clamp(w_sum, min=1e-9)


class HeadClassifier:
    """sklearn-style fit/predict/predict_proba around a class-weighted
    ``MLPHead`` trained on ``device`` (counterpart of ``JaxClassifier``).

    The loop is the JAX package's: features scaled by ``StandardScaler``,
    ``init_head_params`` from a generator seeded by ``cfg.seed``, each
    epoch ``np.random.RandomState(cfg.seed)``'s next permutation cut into
    ``n // batch_size`` batches (a short one refilled from the permutation's
    head), AdamW as ``optax.adamw`` does it with an f32 first moment and
    decay on every parameter. Dropout draws from a generator on ``device``
    seeded by ``cfg.seed``. The features stay on the device for the whole
    fit. ``class_weight`` is None or 'balanced' (sklearn's semantics)."""

    def __init__(self, cfg: HeadConfig, class_weight: str | None = "balanced",
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.class_weight = class_weight
        self.device = torch.device(device)
        self.head: MLPHead | None = None
        self.scaler = StandardScaler()

    def fit(self, X: np.ndarray, y: np.ndarray) -> "HeadClassifier":
        cfg, device = self.cfg, self.device
        Xd = torch.from_numpy(self.scaler.fit_transform(X)).to(device)
        y = np.asarray(y, np.int64)
        yd = torch.from_numpy(y).to(device)
        weights = None
        if self.class_weight == "balanced":
            weights = torch.tensor(compute_class_weights(y, cfg.n_classes), dtype=torch.float32,
                                   device=device)

        head = MLPHead(cfg, device=device).load_params(
            init_head_params(cfg, torch.Generator().manual_seed(cfg.seed)))
        params = dict(head.named_parameters())
        opt = MultiAdamW(params, dict.fromkeys(params, "head"), {"head": cfg.learning_rate},
                         cfg.weight_decay, mu_dtype=torch.float32)
        dropout_gen = torch.Generator(device=device).manual_seed(cfg.seed)

        n = len(y)
        bs = min(cfg.batch_size, n)
        steps = max(1, n // bs)
        np_rng = np.random.RandomState(cfg.seed)
        for _epoch in range(cfg.epochs):
            perm = np_rng.permutation(n)
            batches = np.empty((steps, bs), np.int64)
            for s in range(steps):
                idx = perm[s * bs: (s + 1) * bs]
                if len(idx) < bs:  # the JAX loop keeps its shapes static
                    idx = np.concatenate([idx, perm[: bs - len(idx)]])
                batches[s] = idx
            batches_d = torch.from_numpy(batches).to(device)  # one copy an epoch
            for s in range(steps):
                idx = batches_d[s]
                logits = head(Xd[idx], dropout=cfg.dropout, generator=dropout_gen)
                loss = weighted_softmax_xent(logits, yd[idx], weights, cfg.label_smoothing)
                grads = torch.autograd.grad(loss, list(params.values()))
                opt.step(params, dict(zip(params, grads)))
        self.head = head.eval()
        return self

    @torch.no_grad()
    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        Xd = torch.from_numpy(self.scaler.transform(X)).to(self.device)
        return torch.softmax(self.head(Xd), dim=-1).cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.predict_proba(X).argmax(axis=-1)
