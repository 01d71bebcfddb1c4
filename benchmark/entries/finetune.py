"""Fine-tuning cells: ``FinetuneTrainer.step(..., sync=False)`` over the
batches ``cli/finetune.py`` caches, with that CLI's defaults.

Set-up writes the corpus, decodes the train split once into the CLI's
length-bucketed batches, makes the backbone's and the head's weights on the
card from the seed and hands them to one ``FinetuneTrainer``, then drives
that trainer through its first three updates, in the window's own call, on
three different batches of the first epoch's order. The window goes on with
the same trainer through epochs in permuted orders until ``--seconds`` have
gone by, then waits for the device. The first update that starts after half
of the window is followed: before it the trained leaves, the optimizer's
moments and its count are copied on the card, and its loss, the gradients
the optimizer gets and the norm of each leaf's change are kept. A traced
run profiles a few more updates after the window.

``correct``: the plain float32 reference (``reference/finetune.py``)
follows the first three updates from the same weights, batches and seed,
and the window's followed update's optimizer step from the program's
copied state with the gradients the program's optimizer got; ``check``
lists the numbers compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import yardstick
from benchmark.corpus import read_wav, write_corpus
from benchmark.trace import Spans, profiled
from benchmark.weights import seeded_tensors

FIRST_UPDATES = 3


def leaf_norms(tensors: dict) -> dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def run(ctx) -> dict:
    from stutter_tpu_torch.extract.batcher import BucketBatcher
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files
    from stutter_tpu_torch.models.wavlm import WavLMModel
    from stutter_tpu_torch.train.class_weights import compute_class_weights
    from stutter_tpu_torch.train.finetune import FinetuneConfig, FinetuneModel, FinetuneTrainer

    recipe, device = ctx.traffic["recipe"], ctx.device
    marks = {"start": time.perf_counter()}
    clips = write_corpus(ctx.workdir / "corpus", ctx.traffic, ctx.seed)
    marks["corpus"] = time.perf_counter()
    meta = [r for r in create_metadata_from_files(str(ctx.workdir / "corpus"), split="all")
            if r.get("label") not in (None, "")]
    label_to_idx = {lab: i for i, lab in enumerate(sorted({r["label"] for r in meta}))}
    train = [r for r in meta if r.get("split") == "train"]
    y = np.array([label_to_idx[r["label"]] for r in train], np.int64)
    class_weights = compute_class_weights(y, len(label_to_idx))  # as the CLI does
    model_cfg = ctx.family.model_config(ctx.config)
    cfg = FinetuneConfig(model=model_cfg, n_classes=len(label_to_idx),
                         head_hidden=tuple(recipe["head_hidden"]),
                         head_dropout=recipe["head_dropout"],
                         backbone_lr=recipe["backbone_lr"], head_lr=recipe["head_lr"],
                         weight_decay=recipe["weight_decay"],
                         remat_policy=recipe["remat_policy"],
                         activation_dtype=getattr(torch, recipe["activation_dtype"]),
                         int8_forward=ctx.control,
                         seed=ctx.seed % 2**62)
    shapes = {k: v.shape for k, v in FinetuneModel(
        cfg, WavLMModel(model_cfg, device="meta")).state_dict().items()}
    weights = seeded_tensors(shapes, ctx.seed, device)
    trainer = FinetuneTrainer(cfg, device=device,
                              params={k: v.float() for k, v in weights.items()})
    ctx.sync()
    marks["model"] = time.perf_counter()
    batcher = BucketBatcher(audio_budget_s=recipe["batch_size"] * 3.0,
                            max_batch=recipe["batch_size"], max_length_s=recipe["max_length"],
                            frame_align=(*model_cfg.stem_geometry, 16))
    label_by_path = {r["path"]: int(label_to_idx[r["label"]]) for r in train}
    cached, batch_paths = [], []
    for batch in batcher.batches([r["path"] for r in train]):
        pad = len(batch.waves) - len(batch.paths)
        labels = np.array([label_by_path.get(p, 0) for p in batch.paths] + [0] * pad, np.int32)
        valid = np.array([bool(batch.ok[j]) and p in label_by_path
                          for j, p in enumerate(batch.paths)] + [False] * pad, np.float32)
        cached.append((batch.waves, batch.lengths, labels, valid))
        batch_paths.append(list(batch.paths) + [None] * pad)
    marks["batches"] = time.perf_counter()
    sr = float(ctx.traffic.get("sample_rate", 16000))
    rng = np.random.RandomState(0)  # the CLI's epoch order
    order: list[int] = []

    audio_of = [float((b[1] * (b[3] > 0)).sum()) / sr for b in cached]
    flops_of = [train_flops(ctx.config, b) for b in cached]

    def next_index() -> int:
        if not order:
            order.extend(rng.permutation(len(cached)))
        return order.pop(0)

    def next_batch():
        return cached[next_index()]

    trained = list(trainer.opt.trained)
    grabbed: dict = {}  # the gradients the optimizer gets, for the update that asks
    opt_step = trainer.opt.step

    def grab_step(params, grads):
        if grabbed.pop("ask", False):
            grabbed["grads"] = grads
        return opt_step(params, grads)

    trainer.opt.step = grab_step
    before = {n: trainer.params[n].detach().clone() for n in trained}
    first, losses = [], []
    for k in range(FIRST_UPDATES):
        i = next_index()
        waves, lengths, labels, valid = cached[i]
        first.append((batch_paths[i], waves.shape, labels, valid))
        grabbed["ask"] = k == 0
        losses.append(trainer.step(waves, lengths, labels, class_weights, valid=valid,
                                   sync=False)["loss"])
        if k == 0:  # off the card, so the first gradient holds no device memory
            grads = grabbed.pop("grads")
            grad1 = {n: (torch.zeros(trainer.params[n].shape) if grads.get(n) is None
                         else grads[n].detach().float().cpu()) for n in trained}
            del grads
    ctx.sync()
    change3 = leaf_norms({n: trainer.params[n].detach() - before[n] for n in trained})
    del before
    marks["first_updates"] = time.perf_counter()

    spans = Spans()
    step = trainer.step
    if ctx.trace:
        trainer.step = spans.wrap("enqueue", trainer.step)
        trainer.opt.step = spans.wrap("optim", trainer.opt.step)
    updates, audio, flops, ends, done = 0, 0.0, 0.0, [], []
    followed = None
    ctx.window_started()
    start = time.perf_counter()
    while (time.perf_counter() - start < ctx.seconds or followed is None
           or updates <= followed["at"] + 1):
        i = next_index()
        waves, lengths, labels, valid = cached[i]
        if followed is None and time.perf_counter() - start >= ctx.seconds / 2:
            followed = snapshot(trainer, trained, updates)
            grabbed["ask"] = True
        out = trainer.step(waves, lengths, labels, class_weights, valid=valid, sync=False)
        if followed is not None and "loss" not in followed:
            followed["loss"] = out["loss"]
            followed["grads"] = grabbed.pop("grads")  # as the optimizer got them
            followed["change"] = [(trainer.params[n].detach() - followed["params"][n]).norm()
                                  for n in trained]
        updates, audio, flops = updates + 1, audio + audio_of[i], flops + flops_of[i]
        ends.append(time.perf_counter() - start)
        done.append(audio_of[i])
    ctx.sync()
    wall = time.perf_counter() - start
    trainer.opt.step = opt_step
    followed["end_change"] = [(trainer.params[n].detach() - followed["params"][n]).norm()
                              for n in trained]
    for key in ("change", "end_change"):
        followed[key] = dict(zip(trained, (float(v) for v in followed[key])))
    followed["loss"] = float(followed["loss"])
    half = max(1, updates // 2)
    record = {"window": {"wall_s": wall, "updates": updates, "audio_s": audio,
                         "flops": flops},
              "spans": dict(spans.seconds), "updates": updates, "attempted": updates,
              "failed": 0, "clips": clips, "weights": weights, "first": first,
              "followed": followed, "train_labels": y,
              "n_classes": len(label_to_idx), "trained": trained,
              "program": {"loss": [float(v) for v in losses], "grad1": grad1,
                          "change3": change3},
              "notes": {"setup_parts_s": {k: round(marks[k] - marks[j], 3) for j, k in
                                          zip(marks, list(marks)[1:])},
                        "before_entry_s": round(marks["start"] - ctx.started, 3),
                        "updates": updates, "window_s": round(wall, 4),
                        "followed_update": FIRST_UPDATES + followed["at"] + 1,
                        # the host's pace (it sets the rate) in each half of the window
                        "halves_audio_s_per_s": [
                            sum(done[:half]) / ends[half - 1],
                            sum(done[half:]) / max(ends[-1] - ends[half - 1], 1e-9)]}}
    if ctx.trace:
        from stutter_tpu_torch.ops.wavlm_attention import gated_relpos_attention_backward

        calls0 = gated_relpos_attention_backward.launches
        shapes_seen = []
        with profiled(record):
            for _ in range(ctx.traffic.get("traced_updates", 4)):
                b = next_batch()
                shapes_seen.append(b[0].shape)
                trainer.step(*b[:3], class_weights, valid=b[3], sync=False)
        record["trace_batches"] = shapes_seen
        record["trace_launches"] = {
            "gated_attn_bwd": gated_relpos_attention_backward.launches - calls0}
    trainer.step = step
    del trainer
    return record


def snapshot(trainer, trained, at: int) -> dict:
    """The state the window's update ``at`` starts from, copied on the
    card: the trained leaves and the optimizer's ``state_dict`` (its
    moments and count)."""
    st = trainer.opt.state_dict()
    return {"at": at, "params": {n: trainer.params[n].detach().clone() for n in trained},
            "mu": {n: st["mu"][n].clone() for n in trained},
            "nu": {n: st["nu"][n].clone() for n in trained}, "count": st["count"]}


def train_flops(config: dict, batch) -> float:
    """Model FLOPs of one update: three times the trained encoder's forward
    and the frozen stem's forward, at the valid clips' true lengths; the
    remat's second forward is not counted."""
    _, lengths, _, valid = batch
    total = 0.0
    for n in lengths[valid > 0]:
        enc, stem = yardstick.wavlm_flops_parts(config, int(n))
        total += 3 * enc + stem
    return total


def reference_setup(ctx, record):
    """What every reference update shares: the recipe, the trained leaves'
    learning rates, the class weights and a generator seeded as the
    recipe seeds the program's."""
    from benchmark.reference import finetune as ref

    recipe, trained = ctx.traffic["recipe"], record["trained"]
    lrs = {n: recipe["backbone_lr"] if n.startswith("backbone.") else recipe["head_lr"]
           for n in trained}
    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed % 2**62 + 1)
    return recipe, trained, lrs, ref.class_weights(record["train_labels"],
                                                   record["n_classes"]), gen


def batch_of(first) -> tuple:
    paths, shape, labels, valid = first
    return [None if p is None else read_wav(p) for p in paths], shape, labels, valid


def follow_first(ctx, record):
    """The reference's first updates from the run's weights, batches and
    seed: (losses, first gradient a leaf, change's norm a leaf)."""
    from benchmark.reference import finetune as ref
    from benchmark.reference.wavlm import no_tf32

    recipe, trained, lrs, cw, gen = reference_setup(ctx, record)
    W = {k: v.float().clone().requires_grad_(k in trained)
         for k, v in record["weights"].items()}
    opt = ref.AdamW(lrs, recipe["weight_decay"])
    before = {n: W[n].detach().clone() for n in trained}
    losses, grad1 = [], None
    with no_tf32():
        for first in record["first"]:
            loss, grads = ref.gradients(ctx.config, recipe, W, trained, batch_of(first), cw, gen)
            losses.append(loss)
            if grad1 is None:
                grad1 = grads
            opt.step(W, grads)
            del grads
    return losses, grad1, leaf_norms({n: W[n].detach() - before[n] for n in trained})


def follow_window(ctx, record) -> dict[str, float]:
    """The window's followed update, optimizer alone: the reference's AdamW
    from the program's state before the update (its leaves, moments and
    count) on the gradients the program's optimizer got. Returns each
    leaf's change norm."""
    from benchmark.reference import finetune as ref

    recipe, trained, lrs, _, _ = reference_setup(ctx, record)
    f = record["followed"]
    W = {n: f["params"][n].float().clone() for n in trained}
    opt = ref.AdamW(lrs, recipe["weight_decay"], t=f["count"],
                    mu={n: f["mu"][n].float() for n in trained},
                    nu={n: f["nu"][n].float() for n in trained})
    opt.step(W, {n: torch.zeros_like(W[n]) if f["grads"].get(n) is None
                 else f["grads"][n].float() for n in trained})
    return leaf_norms({n: W[n] - f["params"][n] for n in trained})


def gaps(got: dict, want: dict, leaves) -> dict[str, float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's."""
    median = float(np.median([want[n] for n in leaves]))
    return {n: abs(got[n] - want[n]) / max(want[n], median) for n in leaves}


def moving(norms: dict, trained) -> list[str]:
    """The leaves whose reference gradient is not nought to rounding: a
    thousandth of the median leaf's or more."""
    median = float(np.median([norms[n] for n in trained]))
    return [n for n in trained if norms[n] >= 1e-3 * median]


def cosine_distances(got: dict, want: dict, leaves) -> dict[str, float]:
    """1 - cosine of each leaf's program and reference tensors, in float64."""
    out = {}
    for n in leaves:
        a = got[n].to(want[n].device).double().flatten()
        b = want[n].double().flatten()
        out[n] = float(1.0 - (a @ b) / (a.norm() * b.norm()).clamp(min=1e-300))
    return out


def worst(d: dict, k: int = 3) -> list:
    return sorted(d.items(), key=lambda x: -x[1])[:k]


def check(ctx, record) -> dict[str, float]:
    """The numbers that decide ``correct``.

    The first three updates, against the reference's from the same weights:
    the first update's loss; the first gradient as the optimizer got it, by
    the worst leaf's gap of norms (over the larger of the leaf's reference
    norm and the median leaf's) and the median leaf's cosine distance; the
    median leaf's change over the three. The window's followed update, from
    the program's state before it: the worst leaf's change against the
    reference's optimizer on the program's own gradients, and the leaves
    that no later update of the window moved. (Its loss and gradients are
    not compared: at the window's state bf16's error is magnified some
    fifty times, so the reference's own bf16 reads as far from its float32
    as the program does.) Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the cosines and the
    changes. The notes keep the losses, the worst leaves, and each leaf's
    share of first-gradient elements whose sign the program and the
    reference disagree on."""
    trained, prog = record["trained"], record["program"]
    losses, ref_grad1, change3 = follow_first(ctx, record)
    grad1 = leaf_norms(ref_grad1)
    moving1 = moving(grad1, trained)
    g1 = gaps(leaf_norms(prog["grad1"]), grad1, trained)
    cos1 = cosine_distances(prog["grad1"], ref_grad1, moving1)
    flips = {n: float(((prog["grad1"][n].to(ref_grad1[n].device) > 0) != (ref_grad1[n] > 0))
                      .double().mean()) for n in moving1}
    del ref_grad1
    c3 = gaps(prog["change3"], change3, moving1)
    loss = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], losses)]

    f = record["followed"]
    oc = gaps(f["change"], follow_window(ctx, record), moving1)
    unmoved = [n for n in moving1 if f["end_change"][n] == f["change"][n]]
    record["notes"].update(
        loss=[prog["loss"], losses], loss_gaps=loss,
        grad1_worst=worst(g1), grad1_median=float(np.median(list(g1.values()))),
        grad1_cos_worst=worst(cos1), grad1_cos_max=max(cos1.values()),
        grad1_sign_flips_worst=worst(flips),
        grad1_sign_flips_median=float(np.median(list(flips.values()))),
        change3_worst=worst(c3), change3_max=max(c3.values()),
        followed_loss=f["loss"], optim_change_worst=worst(oc),
        left_out=sorted({n.split(".")[-1] for n in trained if n not in moving1}))
    return {"loss1_gap": loss[0], "grad1_gap": max(g1.values()),
            "grad1_cos_dist": float(np.median(list(cos1.values()))),
            "change3_gap": float(np.median(list(c3.values()))),
            "optim_change_gap": max(oc.values()), "unmoved_after": float(len(unmoved))}
