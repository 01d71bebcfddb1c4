"""Seeded random weights, made on the device in one draw.

The benchmark makes the weights itself: one ``torch.randn`` of every
parameter's values at once, from a generator on the model's device seeded
with the run's seed, in bfloat16 (the type the fast preset serves them in),
then each parameter's slice scaled in place. Matrices and convolution
kernels get 1/sqrt(fan-in) (a name ending in ``.w`` is stored [in, out]), norm scales and the GRU gate's constants 1 +
0.1 n, other vectors 0.02 n. The model loads them with ``load_state_dict``
and the reference reads the same tensors.
"""

from __future__ import annotations

import math

import torch

ONES = ("norm_scale", "ln_scale", "_s", "gru_const")


def std_and_mean(name: str, shape: torch.Size) -> tuple[float, float]:
    if name.endswith(".w"):  # a dense layer stored [in, out]
        return 1.0 / math.sqrt(shape[0]), 0.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    if name.endswith(ONES):
        return 0.1, 1.0
    return 0.02, 0.0


def seeded_weights(model: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """Fill ``model``'s parameters from ``seed`` and return them as
    {state-dict name: bf16 tensor on the model's device}."""
    weights = seeded_tensors({k: v.shape for k, v in model.state_dict().items()}, seed,
                             next(model.parameters()).device)
    model.load_state_dict(weights)
    return weights


def seeded_tensors(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: bf16 tensor of ``shapes[name]`` on ``device``} from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen,
                       device=device, dtype=torch.bfloat16)
    weights, offset = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        std, mean = std_and_mean(name, shape)
        weights[name] = flat[offset: offset + n].view(shape).mul_(std).add_(mean)
        offset += n
    return weights
