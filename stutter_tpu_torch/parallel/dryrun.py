"""One sharded fine-tune step on n ranks (counterpart of ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n)`` runs the full fine-tune step (backbone, layer-
weighted sum, head, AdamW) of a tiny WavLM (hidden 64, 2 layers, 4 heads,
4 classes, head (32,), f32, remat on) on n ranks laid out [n / tp, tp], with
tp = 2 when n is even: the batch splits over the data ranks and the backbone
is cut over the model ranks (Megatron), as the JAX dryrun does on its mesh.
Rank 0 prints ``dryrun_multichip OK: ... loss=...``. On cards the attention
runs through the kernels, which take head_dim 64, so there the 4 heads are
64 wide (hidden 256); on the CPU the plain attention takes the JAX config.

It runs on the cards unless ``device="cpu"`` is given, and never moves to
the CPU by itself: on cards ``backend=None`` means NCCL, one rank a card,
and more ranks than cards raise (``backend="gloo"`` lets ranks share a
card). One rank runs in this process, with no group.
"""

from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import torch

from stutter_tpu_torch.extract.pipeline import resolve_device
from stutter_tpu_torch.models.wavlm import WavLMConfig
from stutter_tpu_torch.parallel.mesh import MeshPlan, launch, make_plan, shard_rows
from stutter_tpu_torch.train.finetune import FinetuneConfig, FinetuneTrainer

N_CLASSES, CLIP_SAMPLES = 4, 3200
HIDDEN = {"cpu": 64, "cuda": 256}  # 4 heads of 16 (the JAX dryrun's), of 64 (the kernels')


def dryrun_config(random_draws: bool = True, hidden_size: int = 64) -> FinetuneConfig:
    """The JAX dryrun's config (at ``hidden_size``); ``random_draws=False``
    turns dropout and SpecAugment off (a parity check cannot share JAX's
    random key)."""
    model = WavLMConfig.tiny(hidden_size=hidden_size, layers=2, heads=4)
    cfg = FinetuneConfig(model=model, n_classes=N_CLASSES, head_hidden=(32,),
                         activation_dtype=torch.float32, remat_encoder=True)
    if not random_draws:
        cfg = dataclasses.replace(cfg, head_dropout=0.0, model=dataclasses.replace(
            model, apply_spec_augment=False))
    return cfg


def dryrun_batch(data_size: int):
    """The JAX dryrun's batch, two clips per data rank, from RandomState(0):
    (waves [B, 3200], lengths, labels, valid)."""
    batch = data_size * 2
    rs = np.random.RandomState(0)
    waves = rs.randn(batch, CLIP_SAMPLES).astype(np.float32) * 0.1
    labels = rs.randint(0, N_CLASSES, size=batch).astype(np.int32)
    return (waves, np.full((batch,), CLIP_SAMPLES, np.int64), labels,
            np.ones((batch,), np.float32))


def dryrun_step(plan: MeshPlan | None, device, params: dict | None = None,
                random_draws: bool = True):
    """One step of this rank: (loss, accuracy, this rank's gradients by
    parameter name, the trainer after its update). ``params`` (a whole
    ``FinetuneModel`` state dict) replaces the seeded init."""
    device = torch.device(device)
    cfg = dryrun_config(random_draws, HIDDEN[device.type])
    trainer = FinetuneTrainer(cfg, device=device, params=params, plan=plan,
                              tensor_parallel=True)
    data = plan.data_size if plan is not None else 1
    waves, lengths, labels, valid = dryrun_batch(data)
    mine = shard_rows(plan, len(waves))
    batch = trainer._tensors(waves[mine], lengths[mine], labels[mine], valid[mine])
    grads, loss, acc = trainer.gradients([batch], np.ones(N_CLASSES, np.float32),
                                         normalize_in_graph=plan is None)
    trainer.opt.step(trainer.params, grads)
    return float(loss), float(acc), grads, trainer


def _rank(n_devices: int, device_type: str) -> None:
    model = 2 if n_devices % 2 == 0 else 1
    plan = make_plan(data=n_devices // model, model=model)
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    loss, _, _, _ = dryrun_step(plan, device)
    _report(plan.data_size, plan.model_size, loss, plan.rank, device)


def _report(data: int, model: int, loss: float, rank: int, device) -> None:
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    if rank == 0:
        print(f"dryrun_multichip OK: mesh data={data} model={model}, batch={data * 2}, "
              f"hidden={HIDDEN[device.type]}, loss={loss:.4f}", flush=True)


def dryrun_multichip(n_devices: int, device: str = "cuda", backend: str | None = None) -> None:
    """Compile and run one sharded fine-tune step on ``n_devices`` ranks."""
    device = resolve_device(device)
    if n_devices == 1:
        loss, _, _, _ = dryrun_step(None, device)
        _report(1, 1, loss, 0, device)
        return
    if device.type == "cuda" and backend is None:
        if n_devices > torch.cuda.device_count():
            raise ValueError(f"{n_devices} ranks on {torch.cuda.device_count()} card(s): NCCL "
                             "puts one rank on a card; pass backend='gloo' to share cards")
        backend = "nccl"
    with tempfile.TemporaryDirectory() as store_dir:
        launch(_rank, n_devices, (n_devices, device.type), device_type=device.type,
               backend=backend or "gloo", store_dir=store_dir)
