"""AdamW as the JAX package's fine-tune builds it with optax.

``stutter_tpu/train/finetune.py:make_optimizer`` is
``optax.multi_transform`` over three labels: ``backbone`` and ``head`` get
``optax.adamw`` with their own learning rates, ``frozen`` gets
``set_to_zero``. Frozen parameters keep no state and are never updated.
Weight decay applies to every trained parameter, biases and norms included
(optax's default: no mask).

The first moment is stored in ``mu_dtype`` (bf16 by default). optax updates
it in f32 from the stored bf16 value, takes this step's update from that f32
value, and stores it rounded; ``torch.optim.AdamW`` keeps its moments in the
parameters' dtype, so the update is written out here, in optax's order and
with its rounding: ``b1 * mu`` is taken in the moment's dtype (a Python
float times a bf16 array stays bf16 in JAX), everything else in f32.
"""

from __future__ import annotations

import numpy as np
import torch

LABELS = ("backbone", "head", "frozen")


class MultiAdamW:
    """``optax.multi_transform({"backbone": adamw, "head": adamw, "frozen":
    set_to_zero})`` over named f32 parameters.

    ``labels`` maps each parameter name to one of ``LABELS``; ``lrs`` maps
    "backbone" and "head" to their learning rates."""

    def __init__(self, params: dict[str, torch.Tensor], labels: dict[str, str],
                 lrs: dict[str, float], weight_decay: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, mu_dtype=torch.bfloat16):
        bad = {lab for lab in labels.values() if lab not in LABELS}
        if bad or set(labels) != set(params):
            raise ValueError(f"labels must name every parameter with one of {LABELS}")
        self.labels = dict(labels)
        self.lrs = dict(lrs)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.mu_dtype = mu_dtype
        # b1 rounded to the moment's dtype, as JAX's weakly typed scalar is;
        # a 0-dim CPU tensor multiplies a tensor on any device without a copy
        self._b1_mu = torch.tensor(b1, dtype=mu_dtype)
        self.trained = [n for n in params if labels[n] != "frozen"]
        self.state = {
            "count": 0,
            "mu": {n: torch.zeros_like(params[n], dtype=mu_dtype) for n in self.trained},
            "nu": {n: torch.zeros_like(params[n]) for n in self.trained},
        }

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor],
             grads: dict[str, torch.Tensor | None]) -> None:
        """Update ``params`` in place from ``grads`` (a missing or None
        gradient counts as zero, as JAX's zero cotangent does)."""
        st = self.state
        st["count"] += 1
        count = np.float32(st["count"])
        # f32, as optax computes decay**count for an int32 count
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** count)
        for n in self.trained:
            p = params[n]
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else g.to(p.dtype)
            mu = g * (1.0 - self.b1) + (st["mu"][n] * self._b1_mu).to(g.dtype)
            nu = st["nu"][n]
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.add_(u * -self.lrs[self.labels[n]])
            st["mu"][n] = mu.to(self.mu_dtype)

    def state_dict(self) -> dict:
        return {"count": self.state["count"], "mu": dict(self.state["mu"]),
                "nu": dict(self.state["nu"])}

    def load_state_dict(self, state: dict) -> None:
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.trained):
                raise ValueError(f"optimizer state {key} does not match the trained parameters")
            for n, t in state[key].items():
                self.state[key][n].copy_(t)
        self.state["count"] = int(state["count"])
