"""Faults planted in the program, to see ``correct`` come out false.

    python3 benchmark/run.py ... --fault <name>

Each fault patches one function of the program where it produces its
answer and returns the function that takes the patch away. The benchmark's
own runs never plant one; the tests and the readings of each fault on the
card do.
"""

from __future__ import annotations

import numpy as np


def _patch(owner, name: str, make):
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    return lambda: setattr(owner, name, real)


def half_batch_mean():
    """Extraction: half of each batch's clips left out, their rows the mean
    of the rest's."""
    from stutter_tpu_torch.extract.pipeline import _Extractor

    counts: list[int] = []

    def submit(real):
        def wrapped(self, batch):
            counts.append(len(batch.rows))
            return real(self, batch)
        return wrapped

    def collect(real):
        def wrapped(self, handle):
            n, out = counts.pop(0), {}
            for col, a in real(self, handle).items():
                a = np.array(a)
                half = max(1, n // 2)
                a[half:n] = a[:half].mean(axis=0)
                out[col] = a
            return out
        return wrapped

    undo = [_patch(_Extractor, "submit", submit), _patch(_Extractor, "collect", collect)]
    return lambda: [u() for u in undo]


def altered_answer():
    """Extraction: the first row of each batch altered as it is produced."""
    from stutter_tpu_torch.extract.pipeline import _Extractor

    def collect(real):
        def wrapped(self, handle):
            cols = {c: np.array(a) for c, a in real(self, handle).items()}
            for a in cols.values():
                a[0] += 0.05 * np.linalg.norm(a[0]) * np.sin(np.arange(a.shape[1]))
            return cols
        return wrapped

    return _patch(_Extractor, "collect", collect)


def dropped_row():
    """Extraction: the first clip of each batch reported as not decoded."""
    from stutter_tpu_torch.extract.pipeline import _Extractor

    def submit(real):
        def wrapped(self, batch):
            batch.ok[0] = False
            return real(self, batch)
        return wrapped

    return _patch(_Extractor, "submit", submit)


def half_batch():
    """Training: half of the batch left out, the loss the mean over the rest."""
    from stutter_tpu_torch.train import finetune

    def xent(real):
        def wrapped(logits, labels, class_weights=None, label_smoothing=0.0, valid=None):
            valid = (valid.clone() if valid is not None
                     else logits.new_ones(logits.shape[0]))
            valid[logits.shape[0] // 2:] = 0
            return real(logits, labels, class_weights, label_smoothing, valid)
        return wrapped

    return _patch(finetune, "weighted_softmax_xent", xent)


def unchanged_state(start: int = 1):
    """Training: from update ``start`` on, a step that returns its state unchanged."""
    from stutter_tpu_torch.train.optim import MultiAdamW

    calls = [0]

    def step(real):
        def wrapped(self, params, grads):
            calls[0] += 1
            if calls[0] < start:
                real(self, params, grads)
        return wrapped

    return _patch(MultiAdamW, "step", step)


FAULTS = {f.__name__: f for f in (half_batch_mean, altered_answer, dropped_row, half_batch,
                                  unchanged_state)}
# from the window's first update on, set-up's three updates left alone
FAULTS["unchanged_state_from_4"] = lambda: unchanged_state(4)
