"""Megatron tensor parallelism for WavLM and Whisper (after ``stutter_tpu/parallel/sharding.py``).

``shard_wavlm`` and ``shard_whisper`` cut a whole model, in place, to this
rank's share on the JAX package's specs (``wavlm_param_spec``,
``whisper_param_spec``): q, k, v and the first FFN product are
column-parallel, o and the second FFN product row-parallel, so each block
ends in one all-reduce; stems, norms, embeddings, WavLM's gate weights and
bucket table stay whole. The port's dense weights are [out, in], so a
column-parallel weight keeps its rows (dim 0) and a row-parallel one its
columns (dim 1); the bias of a row-parallel product stays whole. Turbo's
``QuantizedWeight`` follows the JAX package's ``_lookup`` rule: ``q`` takes
the weight's cut, a column-parallel scale ``s`` is cut with its channels, a
row-parallel scale stays whole.

The head count must divide by the model size (WavLM-Large: 16 heads,
Whisper-large: 20, so tensor parallelism of 2 or 4 serves both), else
``ValueError``.
"""

from __future__ import annotations

import torch

from stutter_tpu_torch.parallel.mesh import MeshPlan

# per-layer parameter (dotted name under the layer) -> the dim it is cut on
WAVLM_LAYER_DIMS = {
    "attention.q_w": 0, "attention.q_b": 0, "attention.k_w": 0, "attention.k_b": 0,
    "attention.v_w": 0, "attention.v_b": 0, "attention.o_w": 1,
    "feed_forward.w1": 0, "feed_forward.b1": 0, "feed_forward.w2": 1,
}
_WHISPER_ATTN_DIMS = {"q_w": 0, "q_b": 0, "k_w": 0, "v_w": 0, "v_b": 0, "o_w": 1}
WHISPER_LAYER_DIMS = {
    **{f"attn.{k}": d for k, d in _WHISPER_ATTN_DIMS.items()},
    **{f"xattn.{k}": d for k, d in _WHISPER_ATTN_DIMS.items()},
    "ffn.fc1_w": 0, "ffn.fc1_b": 0, "ffn.fc2_w": 1,
}


def shard_dim(name: str, layer_dims: dict) -> int | None:
    """The dim a state-dict entry ``...layers.{i}.<key>[.q|.s]`` is cut on,
    None when it stays whole."""
    parts = name.split(".")
    if "layers" not in parts:
        return None
    key = ".".join(parts[parts.index("layers") + 2:])
    if key in layer_dims:
        return layer_dims[key]
    base, _, leaf = key.rpartition(".")
    if base in layer_dims and leaf == "q":
        return layer_dims[base]
    if base in layer_dims and leaf == "s":  # [N]: cut with column-parallel channels
        return 0 if layer_dims[base] == 0 else None
    return None


def cut(t: torch.Tensor, dim: int | None, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size`` equal contiguous pieces of t along dim."""
    if dim is None or size == 1:
        return t
    n = t.shape[dim]
    if n % size:
        raise ValueError(f"dim {dim} of {n} does not split over {size} ranks")
    return t.narrow(dim, rank * (n // size), n // size)


def _shard_module(module: torch.nn.Module, layer_dims: dict, plan: MeshPlan) -> None:
    """Replace every cut tensor of the module by this rank's contiguous piece."""
    for name, tensor in list(module.state_dict(keep_vars=True).items()):
        dim = shard_dim(name, layer_dims)
        if dim is None:
            continue
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path))
        piece = cut(tensor.detach(), dim, plan.model_rank, plan.model_size).contiguous()
        if isinstance(tensor, torch.nn.Parameter):
            setattr(owner, leaf, torch.nn.Parameter(piece, requires_grad=tensor.requires_grad))
        else:
            owner.register_buffer(leaf, piece)


def _check_heads(heads: int, plan: MeshPlan, what: str) -> int:
    if heads % plan.model_size:
        raise ValueError(f"{what} has {heads} heads: tensor parallelism must divide them, "
                         f"got {plan.model_size}")
    return heads // plan.model_size


def shard_wavlm(model, plan: MeshPlan | None):
    """Cut a whole ``WavLMModel`` (any dtype, turbo included) to this rank's
    Megatron share in place and hand its blocks the model group; returns it.
    A plan without a model axis leaves it whole."""
    if plan is None or plan.model_size == 1:
        return model
    H = _check_heads(model.cfg.num_attention_heads, plan, "WavLM")
    _shard_module(model, WAVLM_LAYER_DIMS, plan)
    start = plan.model_rank * H
    model.head_range, model.tp_group = (start, start + H), plan.model_group
    for layer in model.layers:
        layer.attention.heads, layer.attention.head_offset = H, start
        layer.attention.tp_group = layer.feed_forward.tp_group = plan.model_group
    return model


def shard_whisper(model, plan: MeshPlan | None):
    """Cut a whole ``WhisperModel`` (encoder and decoder, turbo included) to
    this rank's Megatron share in place; returns it."""
    if plan is None or plan.model_size == 1:
        return model
    cfg = model.cfg
    enc_h = _check_heads(cfg.encoder_attention_heads, plan, "the Whisper encoder")
    dec_h = _check_heads(cfg.decoder_attention_heads, plan, "the Whisper decoder")
    _shard_module(model, WHISPER_LAYER_DIMS, plan)
    for layers, heads in ((model.encoder.layers, enc_h), (model.decoder.layers, dec_h)):
        for layer in layers:
            for attn in (layer.attn, getattr(layer, "xattn", None)):
                if attn is not None:
                    attn.heads, attn.tp_group = heads, plan.model_group
            layer.ffn.tp_group = plan.model_group
    return model
