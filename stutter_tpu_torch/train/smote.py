"""SMOTE oversampling as a k-NN interpolation on the device (counterpart of
``stutter_tpu/train/smote.py``).

The reference's imblearn semantics (``model_training_01.py:390-418``):
every class is brought up to the majority count; the effective ``k`` is
``min(k_neighbors, min_class_size - 1)``; below 1, the inputs come back
unchanged. The draws (``smote_draws``) come from a seeded CPU
``torch.Generator``, so that the same seed gives the same samples on any
device; the distances, the top-k and the interpolation
(``smote_interpolate``) run on the device the caller names, in full f32
(TF32 could reorder the neighbours). The JAX package draws from
``jax.random`` instead, so the two packages' samples differ for one seed;
given the same draws they agree.

Unlike the JAX package, which continues without SMOTE on any exception, an
error here (a CUDA error among them) propagates.
"""

from __future__ import annotations

import logging
from collections import Counter

import numpy as np
import torch

from stutter_tpu_torch.ops.precision import no_tf32

logger = logging.getLogger("stutter_tpu_torch.train.smote")


def smote_draws(generator: torch.Generator, n: int, k: int, n_new: int,
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(base [n_new] int64, pick [n_new] int64, gap [n_new, 1] f32) on the
    generator's device: the sample each new one starts from, which of its k
    neighbours it moves toward, and how far."""
    device = generator.device
    base = torch.randint(0, n, (n_new,), generator=generator, device=device)
    pick = torch.randint(0, k, (n_new,), generator=generator, device=device)
    gap = torch.rand((n_new, 1), generator=generator, device=device)
    return base, pick, gap


def smote_neighbors(x: torch.Tensor, k: int) -> torch.Tensor:
    """[n, k] indices of each row's k nearest other rows of ``x`` [n, d]
    (squared distances sq_i + sq_j - 2 x.x^T, self excluded)."""
    with no_tf32():
        sq = (x * x).sum(dim=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
        d2 = d2 + torch.eye(len(x), dtype=x.dtype, device=x.device) * 1e30
        return torch.topk(-d2, k, dim=1).indices


def smote_interpolate(x: torch.Tensor, k: int, base: torch.Tensor, pick: torch.Tensor,
                      gap: torch.Tensor) -> torch.Tensor:
    """The new samples of one class block ``x`` [n, d]:
    x[base] + gap * (x[neighbour] - x[base])."""
    neigh = smote_neighbors(x, k)[base, pick]
    return x[base] + gap * (x[neigh] - x[base])


def apply_smote_oversampling(X: np.ndarray, y: np.ndarray, k_neighbors: int = 3,
                             random_state: int = 42, device: torch.device | str = "cuda",
                             ) -> tuple[np.ndarray, np.ndarray]:
    """Balance the classes to the majority count. Returns the original rows
    first, then each class's new rows, classes in ``sorted(..., key=str)``
    order."""
    X = np.asarray(X, np.float32)
    y = np.asarray(y)
    dist = Counter(y.tolist())
    logger.info("original distribution: %s", dict(dist))

    k = min(k_neighbors, min(dist.values()) - 1)
    if k < 1:
        logger.warning("some classes have too few samples for SMOTE; skipping oversampling")
        return X, y

    majority = max(dist.values())
    generator = torch.Generator().manual_seed(random_state)
    new_X, new_y = [X], [y]
    for cls in sorted(dist, key=str):
        n_new = majority - dist[cls]
        if n_new <= 0:
            continue
        block = torch.from_numpy(X[y == cls]).to(device)
        draws = (d.to(device) for d in smote_draws(generator, len(block), k, n_new))
        new_X.append(smote_interpolate(block, k, *draws).cpu().numpy())
        new_y.append(np.full(n_new, cls, dtype=y.dtype))
    Xr = np.concatenate(new_X)
    yr = np.concatenate(new_y)
    logger.info("after SMOTE distribution: %s", dict(Counter(yr.tolist())))
    logger.info("total samples: %d -> %d", len(y), len(yr))
    return Xr, yr
