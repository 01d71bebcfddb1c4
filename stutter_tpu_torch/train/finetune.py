"""End-to-end fine-tuning: WavLM backbone + layer-weighted sum + MLP head.

Counterpart of ``stutter_tpu/train/finetune.py``: the softmax-weighted sum
over all N+1 hidden states, the masked mean-pool (taken inside the layer
loop, so the [N+1, B, L, D] stack never exists), the MLP head, class-weighted
cross-entropy, AdamW with separate backbone and head learning rates
(``train/optim.py``), per-layer remat and exact gradient accumulation.

Mixed precision as in the JAX package: the f32 master weights are cast to
the activation dtype once per step, outside the remat boundary, and the
model runs on that cast (``WavLMModel.pooled_states(params=...)``, through
``torch.func.functional_call``), so gradients reach the masters through the
cast exactly as through JAX's ``astype``; norms run on the cast weights with
f32 statistics, as in JAX. Every attention call goes forward through the CUDA
kernel and backward through the backward kernels on the card
(``ops.wavlm_attention.GatedRelPosAttentionFn``), and through their plain
versions on the CPU.

Data parallelism (``FinetuneTrainer(plan=...)``): each rank takes its rows of
every batch, differentiates their un-normalised loss sum, and the gradient
sums, the weight mass, the hits and the valid counts are all-reduced over
the data group before the one division: the JAX package's global weighted
mean, not a mean of per-rank means. Under a model axis the weights are
replicated on it (the JAX CLI's layout), unless ``tensor_parallel`` cuts
the backbone to the rank's Megatron share (``dryrun_multichip``).

Spans (``utils.profiling.span``): ``finetune.step`` an update (``step`` or
``step_accum``), with its children ``finetune.h2d`` (the batch's copies to
the device), ``finetune.forward`` (forward and loss) and
``finetune.backward`` (the gradients) for each microbatch,
``finetune.optim`` (``MultiAdamW.step``) and, with ``sync=True``,
``finetune.sync`` (the wait for the host floats).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from stutter_tpu_torch.extract.pipeline import resolve_device
from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
from stutter_tpu_torch.models.wavlm import REMAT_MODES, WavLMConfig, WavLMModel
from stutter_tpu_torch.ops.precision import no_tf32
from stutter_tpu_torch.ops.specaugment import spec_augment
from stutter_tpu_torch.parallel.mesh import MeshPlan
from stutter_tpu_torch.parallel.sharding import shard_wavlm
from stutter_tpu_torch.train.heads import (
    HeadConfig,
    MLPHead,
    weighted_softmax_xent,
    weighted_xent_sums,
)
from stutter_tpu_torch.train.optim import MultiAdamW
from stutter_tpu_torch.utils.profiling import span

logger = logging.getLogger("stutter_tpu_torch.train.finetune")

@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """The JAX package's fields. Three are TPU dispatch or XLA knobs that the
    port ignores: ``precision`` (f32 runs in full f32 on the card, TF32
    off), ``accum_unroll`` (no scan here) and ``use_flash_attention`` (the
    port always takes its attention kernel). ``cast_params = False`` with a
    bf16 activation dtype is not ported and raises: PyTorch refuses a bf16 x
    f32 product where JAX promotes it.

    ``int8_forward`` runs the six projections of every layer through
    ``ops.quant.qdot_ste`` (int8 forward, the plain product's backward), in
    training and evaluation alike, as in JAX."""

    model: WavLMConfig
    n_classes: int
    head_hidden: tuple[int, ...] = (256,)
    head_dropout: float = 0.1
    backbone_lr: float = 1e-5
    head_lr: float = 1e-3
    weight_decay: float = 1e-4
    freeze_feature_encoder: bool = True
    freeze_backbone: bool = False  # True = SUPERB-style weighted-sum probe
    remat_encoder: bool = True
    # "layer": checkpoint each encoder layer; "nothing": the whole encoder;
    # "layer_dots" / "dots": the same keeping the GEMMs' outputs;
    # "layer_probs": each layer keeping all but the attention core
    # (models/wavlm.py: save_only, SaveAllButAttention)
    remat_policy: str = "layer"
    precision: Any = None
    activation_dtype: torch.dtype = torch.bfloat16
    cast_params: bool = True
    mu_dtype: torch.dtype = torch.bfloat16  # adamw's first moment
    accum_unroll: int = 1
    use_flash_attention: bool | None = None
    int8_forward: bool = False
    seed: int = 0

    def remat(self) -> str | None:
        """The ``pooled_states`` remat mode."""
        if not self.remat_encoder:
            return None
        if self.remat_policy not in REMAT_MODES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r}")
        return self.remat_policy

    def check_supported(self) -> None:
        if not self.cast_params and self.activation_dtype != torch.float32:
            raise NotImplementedError("cast_params=False (f32 weights into bf16 "
                                      "activations) is not ported")
        self.remat()


def param_label(name: str, cfg: FinetuneConfig) -> str:
    """The optimizer label of a ``FinetuneModel`` parameter (``make_optimizer``'s
    ``label_fn``): the stem is frozen under ``freeze_feature_encoder``, the
    whole backbone under ``freeze_backbone``; ``layer_weights`` is head."""
    if name.startswith("backbone."):
        if cfg.freeze_backbone:
            return "frozen"
        if cfg.freeze_feature_encoder and name.startswith("backbone.feature_encoder."):
            return "frozen"
        return "backbone"
    return "head"


class FinetuneModel(nn.Module):
    """Backbone (an f32 ``WavLMModel``), ``layer_weights`` (zeros, one per
    hidden state) and the MLP head; trained parameters require grad."""

    def __init__(self, cfg: FinetuneConfig, backbone: WavLMModel):
        super().__init__()
        self.cfg = cfg
        self.backbone = backbone
        device = backbone.rel_attn_embed.device
        self.layer_weights = nn.Parameter(
            torch.zeros(cfg.model.num_hidden_layers + 1, device=device))
        self.head = MLPHead(HeadConfig(in_dim=cfg.model.hidden_size, n_classes=cfg.n_classes,
                                       hidden_dims=cfg.head_hidden, dropout=cfg.head_dropout),
                            device=device)
        for name, p in self.named_parameters():
            p.requires_grad_(param_label(name, cfg) != "frozen")
        for layer in backbone.layers:
            layer.attention.int8_forward = layer.feed_forward.int8_forward = cfg.int8_forward


def init_finetune_model(cfg: FinetuneConfig, backbone: WavLMModel | None = None,
                        device: torch.device | str = "cuda") -> FinetuneModel:
    """Random backbone from ``init_wavlm`` (seed ``cfg.seed``) unless one is
    given, zero layer weights, He-normal head (seed ``cfg.seed + 1``), on
    ``device`` (a card unless the caller names the CPU)."""
    from stutter_tpu_torch.weights.convert import init_wavlm

    device = resolve_device(device)
    if backbone is None:
        backbone = init_wavlm(cfg.model, torch.Generator().manual_seed(cfg.seed))
    model = FinetuneModel(cfg, backbone.to(device=device, dtype=torch.float32))
    model.head.init_(torch.Generator().manual_seed(cfg.seed + 1))
    return model


def cast_backbone(model: FinetuneModel, cfg: FinetuneConfig) -> dict[str, torch.Tensor]:
    """The backbone's parameters in the activation dtype, by state-dict name:
    one cast per step, differentiable back to the f32 masters."""
    dtype = cfg.activation_dtype if cfg.cast_params else torch.float32
    return {name: p.to(dtype) for name, p in model.backbone.named_parameters()}


def finetune_forward(model: FinetuneModel, waves: torch.Tensor, lengths: torch.Tensor,
                     cfg: FinetuneConfig, train: bool = False,
                     generator: torch.Generator | None = None,
                     backbone_params: dict[str, torch.Tensor] | None = None,
                     attention_fn=None) -> torch.Tensor:
    """[B, T] padded waves + [B] lengths -> [B, n_classes] f32 logits.

    ``backbone_params`` is the step's cast (made here when None);
    ``attention_fn`` replaces the attention core (the kernel's autograd
    Function by default)."""
    mcfg = cfg.model
    x = wavlm_prepare_batch(waves, lengths, mcfg.do_normalize)
    if backbone_params is None:
        backbone_params = cast_backbone(model, cfg)
    augment = None
    if train and generator is not None and mcfg.apply_spec_augment:
        def augment(hidden, frame_lengths, mask_embedding):
            return spec_augment(hidden, frame_lengths, mcfg.mask_time_prob,
                                mcfg.mask_time_length, mcfg.mask_feature_prob,
                                mcfg.mask_feature_length, mask_embedding, generator)
    states = model.backbone.pooled_states(
        x, lengths, params=backbone_params,
        stop_stem_gradient=cfg.freeze_feature_encoder or cfg.freeze_backbone,
        augment=augment, remat=cfg.remat() if train else None, attention_fn=attention_fn)
    if cfg.freeze_backbone:
        states = states.detach()
    w = torch.softmax(model.layer_weights, dim=0)
    pooled = torch.einsum("s,sbd->bd", w, states.float())
    return model.head(pooled, dropout=cfg.head_dropout if train else 0.0,
                      generator=generator)


class FinetuneTrainer:
    """Fine-tuning over padded (waves, lengths, labels, valid) batches:
    ``step`` (one batch), ``step_accum`` (K same-shape microbatches, one
    update) and ``predict``, on ``device`` (a card unless the caller names
    the CPU).

    ``params`` (a ``FinetuneModel`` state dict, e.g. from
    ``weights.convert.finetune_params_from_numpy``) sets every weight;
    otherwise ``backbone`` (an f32 ``WavLMModel``) or a seeded random one,
    with a seeded head. ``attention_fn`` replaces the attention core (the
    on-card comparison with the plain path).

    ``plan`` makes it data-parallel: every rank calls ``step`` and
    ``step_accum`` in the same order with its rows of each batch
    (``parallel.mesh.shard_rows``), and takes the same update, from gradients
    summed over the data group. ``tensor_parallel`` cuts the backbone to the
    rank's share on the plan's model group; without it the model axis
    replicates the weights. Dropout and SpecAugment draw from a generator
    seeded per data rank."""

    def __init__(self, cfg: FinetuneConfig, backbone: WavLMModel | None = None,
                 device: torch.device | str = "cuda", grad_accum: int = 1,
                 params: dict[str, torch.Tensor] | None = None, attention_fn=None,
                 plan: MeshPlan | None = None, tensor_parallel: bool = False):
        cfg.check_supported()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.grad_accum = int(grad_accum)
        self.attention_fn = attention_fn
        self.plan = plan
        if params is not None:
            self.model = FinetuneModel(cfg, WavLMModel(cfg.model, device="meta"))
            self.model = self.model.to_empty(device=self.device)
            self.model.load_state_dict(params, strict=True)
        else:
            self.model = init_finetune_model(cfg, backbone, self.device)
        if tensor_parallel:
            shard_wavlm(self.model.backbone, plan)
        self.params = dict(self.model.named_parameters())
        self.opt = MultiAdamW(
            self.params, {n: param_label(n, cfg) for n in self.params},
            {"backbone": cfg.backbone_lr, "head": cfg.head_lr}, cfg.weight_decay,
            mu_dtype=cfg.mu_dtype)
        # dropout and SpecAugment draw on the device they run on, one stream
        # per data rank (a model group's ranks draw alike)
        data_rank = plan.data_rank if plan is not None else 0
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1 + data_rank)

    def _precision(self):
        f32 = self.device.type == "cuda" and self.cfg.activation_dtype == torch.float32
        return no_tf32() if f32 else contextlib.nullcontext()

    def _to_device(self, x, dtype) -> torch.Tensor:
        """A host array on the device; to a card through pinned memory and
        without blocking the host, so steps enqueue back to back."""
        t = torch.from_numpy(np.ascontiguousarray(x, dtype))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _tensors(self, waves, lengths, labels=None, valid=None):
        out = [self._to_device(waves, np.float32), self._to_device(lengths, np.int64)]
        if labels is not None:
            out.append(self._to_device(labels, np.int64))
            out.append(self._to_device(np.ones(len(labels)) if valid is None else valid,
                                       np.float32))
        return out

    def _accuracy_parts(self, logits, labels, valid):
        hits = (logits.argmax(dim=-1) == labels).float()
        return (hits * valid).sum(), valid.sum()

    def gradients(self, microbatches, class_weights, normalize_in_graph: bool):
        """(grads {name: f32 tensor}, loss, accuracy) over the microbatches.

        With one microbatch and ``normalize_in_graph`` the loss is the
        weighted mean, differentiated through the cast (``make_train_step``).
        Otherwise each microbatch's un-normalised loss sum is differentiated
        with respect to the step's cast, those gradients are summed in f32 and
        normalised once by the total weight mass (``_make_accum_train_step``);
        under a plan the sums are first added up over the data group."""
        cfg = self.cfg
        cw = self._to_device(class_weights, np.float32)
        trained = self.opt.trained
        with self._precision():
            if normalize_in_graph:
                (w, l, y, v), = microbatches
                with span("finetune.forward", microbatch=0):
                    logits = finetune_forward(self.model, w, l, cfg, train=True,
                                              generator=self.generator,
                                              attention_fn=self.attention_fn)
                    loss = weighted_softmax_xent(logits, y, cw, valid=v)
                with span("finetune.backward", microbatch=0):
                    grads = torch.autograd.grad(loss, [self.params[n] for n in trained],
                                                allow_unused=True)
                hits, n_valid = self._accuracy_parts(logits.detach(), y, v)
                return (dict(zip(trained, grads)), loss.detach(),
                        hits / torch.clamp(n_valid, min=1.0))
            cast = cast_backbone(self.model, cfg)
            # differentiate with respect to the cast backbone leaves (bf16
            # gradients, upcast and summed in f32, as JAX's scan does) and the
            # f32 head and layer weights
            leaves = {n: (cast[n[len("backbone."):]] if n.startswith("backbone.")
                          else self.params[n]) for n in trained}
            g_sum = {n: torch.zeros_like(self.params[n]) for n in trained}
            zero = torch.zeros((), device=self.device)
            loss_sum, w_sum, hits, n_valid = zero, zero, zero, zero
            for k, (w, l, y, v) in enumerate(microbatches):
                with span("finetune.forward", microbatch=k):
                    logits = finetune_forward(self.model, w, l, cfg, train=True,
                                              generator=self.generator, backbone_params=cast,
                                              attention_fn=self.attention_fn)
                    ls, ws = weighted_xent_sums(logits, y, cw, valid=v)
                with span("finetune.backward", microbatch=k):
                    grads = torch.autograd.grad(ls, list(leaves.values()), allow_unused=True)
                    for n, g in zip(trained, grads):
                        if g is not None:
                            g_sum[n] += g.float()
                h, nv = self._accuracy_parts(logits.detach(), y, v)
                loss_sum, w_sum = loss_sum + ls.detach(), w_sum + ws.detach()
                hits, n_valid = hits + h, n_valid + nv
            if self.plan is not None:
                g_sum, (loss_sum, w_sum, hits, n_valid) = self._sum_over_data(
                    g_sum, (loss_sum, w_sum, hits, n_valid))
            denom = torch.clamp(w_sum, min=1e-9)
            return ({n: g / denom for n, g in g_sum.items()}, loss_sum / denom,
                    hits / torch.clamp(n_valid, min=1.0))

    def _sum_over_data(self, grads: dict, scalars: tuple):
        """Gradient sums and scalar sums added up over the data group, in one
        all-reduce of one flat f32 buffer."""
        names = list(grads)
        flat = torch.cat([grads[n].reshape(-1) for n in names] + [torch.stack(scalars)])
        dist.all_reduce(flat, group=self.plan.data_group)
        out, at = {}, 0
        for n in names:
            size = grads[n].numel()
            out[n] = flat[at: at + size].view_as(grads[n])
            at += size
        return out, tuple(flat[at:])

    def _finish(self, loss, acc, sync: bool):
        aux = {"loss": loss, "accuracy": acc}
        if not sync:
            return aux
        with span("finetune.sync"):
            return {k: float(v) for k, v in aux.items()}

    def step(self, waves, lengths, labels, class_weights, valid=None, sync: bool = True):
        """One training step on one batch. sync=True returns host floats;
        sync=False returns the device tensors without waiting for them. Under
        a plan the step takes the summed path of ``step_accum`` (one
        microbatch), whose sums the data group adds up."""
        with span("finetune.step", update=self.opt.state["count"] + 1):
            with span("finetune.h2d"):
                batch = self._tensors(waves, lengths, labels, valid)
            grads, loss, acc = self.gradients([batch], class_weights,
                                              normalize_in_graph=self.plan is None)
            with span("finetune.optim"):
                self.opt.step(self.params, grads)
            return self._finish(loss, acc, sync)

    def step_accum(self, microbatches, class_weights, sync: bool = True):
        """One update over up to ``grad_accum`` same-shape microbatches
        ``(waves [B, T], lengths [B], labels [B], valid [B])``; a short group
        is padded by repeating its last microbatch with ``valid = 0``, which
        the weight-mass normalisation makes a no-op (as in the JAX package)."""
        K = self.grad_accum
        if not 1 <= len(microbatches) <= K:
            raise ValueError(f"{len(microbatches)} microbatches for grad_accum={K}")
        mbs = list(microbatches)
        while len(mbs) < K:
            w, l, y, _ = mbs[-1]
            mbs.append((w, l, y, np.zeros(len(np.asarray(y)), np.float32)))
        with span("finetune.step", update=self.opt.state["count"] + 1):
            with span("finetune.h2d"):
                batches = [self._tensors(*mb) for mb in mbs]
            grads, loss, acc = self.gradients(batches, class_weights, normalize_in_graph=False)
            with span("finetune.optim"):
                self.opt.step(self.params, grads)
            return self._finish(loss, acc, sync)

    @torch.no_grad()
    def predict(self, waves, lengths) -> np.ndarray:
        w, l = self._tensors(waves, lengths)
        with self._precision():
            logits = finetune_forward(self.model, w, l, self.cfg, train=False,
                                      attention_fn=self.attention_fn)
        return logits.argmax(dim=-1).cpu().numpy()

    def state_dict(self) -> dict[str, torch.Tensor]:
        return self.model.state_dict()
