"""Fine-tuning's remat policies and int8_forward in the port, against its own
"layer" step and against the JAX package's same policy, on the CPU.

A tiny f32 WavLM, the same numpy inputs and weights in both packages
(``finetune_params_from_numpy``):
- "layer_dots", "layer_probs" and "dots" leave the loss and every gradient
  of "layer" unchanged to 1e-6 (they only choose what the backward
  recomputes), and one step of each matches JAX's step of the same policy
  at ``test_torch_finetune.py``'s bar for the "layer" step; each runs its
  kept products once (counted at dispatch), not again in the backward;
- ``qdot_ste``'s quantized operands, int32 accumulators and f32 product are
  bit-equal to JAX's, and its backward is the plain product's, exactly;
- one ``int8_forward`` step against JAX's: the loss and every leaf's
  gradient, then the parameters after the update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from stutter_tpu.ops import quant as jq
from stutter_tpu.train import finetune as jft
from stutter_tpu_torch.models.wavlm import GEMMS, REMAT_MODES, UNBATCHED_GEMMS
from stutter_tpu_torch.ops import quant as tq
from stutter_tpu_torch.train.finetune import FinetuneConfig, FinetuneTrainer
from stutter_tpu_torch.weights.convert import finetune_params_from_numpy, flatten_tree
from tests.test_torch_finetune import (
    _assert_params_close,
    _batch,
    _configs,
    _pair,
    _tiny,
    _tree,
)

torch.set_num_threads(2)  # six xdist workers share the host

CW = np.array([1.0, 2.0, 0.5], np.float32)
# a policy against "layer" in the port: the same arithmetic, recomputed or
# kept, so only the order of the gradient sums of a checkpoint can differ
POLICY_VS_LAYER = 1e-6
# int8_forward's gradients against JAX's int8_forward gradients, leaf by
# leaf: the norm of the difference over the norm of JAX's (measured <= 2.3e-6;
# the plain f32 step's leaves measure <= 2.0e-6). The key bias's exact
# gradient is 0, so both packages' k_b gradients are noise: each is held
# under K_B_NOISE of the largest backbone gradient (measured 6e-9 against
# ~0.1).
INT8_GRAD_REL = 1e-5
K_B_NOISE = 1e-6
INT8_LOSS_RTOL = 1e-5


def _grads(trainer, batch):
    waves, lengths, labels, valid = batch
    mb = trainer._tensors(waves, lengths, labels, valid)
    grads, loss, _ = trainer.gradients([tuple(mb)], CW, normalize_in_graph=True)
    return {n: g for n, g in grads.items() if g is not None}, float(loss)


def _port_trainer(policy, tree, mcfg, **kw):
    _, cfg = _configs(mcfg, remat_policy=policy, **kw)
    return FinetuneTrainer(cfg, device="cpu", params=finetune_params_from_numpy(tree, mcfg))


@pytest.fixture(scope="module")
def layer_reference():
    mcfg = _tiny()
    _, tt, tree = _pair(mcfg)
    batch = _batch(np.random.RandomState(3))
    grads, loss = _grads(tt, batch)
    return mcfg, tree, batch, grads, loss


def test_remat_modes_cover_jax_policies():
    assert set(REMAT_MODES) == {None, "layer", "layer_dots", "layer_probs", "nothing", "dots"}
    with pytest.raises(ValueError, match="unknown remat_policy"):
        FinetuneConfig(model=_tiny(), n_classes=2, remat_policy="everything").check_supported()


@pytest.mark.parametrize("policy", ["layer_dots", "layer_probs", "dots", "nothing"])
def test_policy_gradients_equal_layer(layer_reference, policy):
    mcfg, tree, batch, ref_grads, ref_loss = layer_reference
    grads, loss = _grads(_port_trainer(policy, tree, mcfg), batch)
    assert loss == pytest.approx(ref_loss, rel=POLICY_VS_LAYER, abs=0)
    assert set(grads) == set(ref_grads)
    for n, g in ref_grads.items():
        scale = max(1e-12, float(g.abs().max()))
        torch.testing.assert_close(grads[n], g, rtol=0, atol=POLICY_VS_LAYER * scale, msg=n)


class _GemmCounter(TorchDispatchMode):
    """Counts the products dispatched: unbatched (mm, addmm, _int_mm) and
    batched (bmm). A product that a checkpoint kept is not dispatched again
    in the backward."""

    def __init__(self):
        super().__init__()
        self.unbatched = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in UNBATCHED_GEMMS:
            self.unbatched += 1
        elif func in GEMMS:
            self.batched += 1
        return func(*args, **(kwargs or {}))


def _gemm_counts(policy, tree, mcfg, batch, **kw):
    with _GemmCounter() as counter:
        _grads(_port_trainer(policy, tree, mcfg, **kw), batch)
    return counter.unbatched, counter.batched


@pytest.mark.parametrize("policy,batched_as", [("layer_dots", None), ("layer_probs", "layer"),
                                               ("dots", "nothing")])
def test_policy_keeps_what_it_names(layer_reference, policy, batched_as):
    """Over one step's forward and backward, each policy runs its unbatched
    products (the projections) as often as a step with no checkpoint, so
    none is run again, where "layer" and "nothing" run them again. The
    batched ones (the attention's) are kept under "layer_dots" only:
    "layer_probs" runs them again as "layer" does, "dots" as "nothing"."""
    mcfg, tree, batch, _, _ = layer_reference
    none = _gemm_counts("layer", tree, mcfg, batch, remat_encoder=False)
    recomputing = _gemm_counts("layer" if policy.startswith("layer") else "nothing",
                               tree, mcfg, batch)
    ours = _gemm_counts(policy, tree, mcfg, batch)
    assert ours[0] == none[0] < recomputing[0]
    expected = none if batched_as is None else _gemm_counts(batched_as, tree, mcfg, batch)
    assert ours[1] == expected[1]


@pytest.mark.parametrize("policy", ["layer_dots", "layer_probs", "dots"])
def test_policy_step_matches_jax(layer_reference, policy):
    mcfg, _, batch, _, _ = layer_reference
    jt, tt, _ = _pair(mcfg, remat_policy=policy)
    waves, lengths, labels, valid = batch
    aux_j = jt.step(waves, lengths, labels, CW, valid=valid)
    aux_t = tt.step(waves, lengths, labels, CW, valid=valid)
    np.testing.assert_allclose(aux_t["loss"], aux_j["loss"], rtol=1e-5)
    ref = flatten_tree(jax.tree.map(np.asarray, jt.params))
    _assert_params_close(_tree(tt, mcfg), ref, tt.cfg.backbone_lr)


def _bf16_pair(rng, shape, scale=1.0):
    a = jnp.asarray(rng.randn(*shape).astype(np.float32) * scale, jnp.bfloat16)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("M", [5, 40])
def test_qdot_ste_forward_bit_equal_to_jax(rng, M):
    """JAX's weight is [K, N], the port's [N, K]; the live weight is
    quantized inside the call."""
    jw_, tw_ = _bf16_pair(rng, (128, 48), 0.05)
    jx, tx = _bf16_pair(rng, (2, M, 128))
    q, s = tq.quantize_weight(tw_.t())
    acc, st = tq.qdot_accumulators(tx, q)
    jqw = jq.quantize_weight(jw_)
    xf = jx.astype(jnp.float32)
    jst = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-8)
    jxq = jnp.clip(jnp.round(xf / jst), -127, 127).astype(jnp.int8)
    jacc = jax.lax.dot_general(jxq, jqw["q"], (((2,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    ours = tq.qdot_ste(tx, tw_.t())
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jq.qdot_ste(jx, jw_)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qdot_ste_backward_is_the_plain_products(rng, dtype):
    x = torch.from_numpy(rng.randn(3, 7, 64).astype(np.float32)).to(dtype).requires_grad_()
    w = torch.from_numpy(rng.randn(24, 64).astype(np.float32) * 0.1).to(dtype).requires_grad_()
    g = torch.from_numpy(rng.randn(3, 7, 24).astype(np.float32))
    y = tq.qdot_ste(x, w)
    assert y.dtype == torch.float32
    dx, dw = torch.autograd.grad(y, (x, w), g)
    # the plain product's backward, the cotangent first cast to w's dtype
    gx, gw = torch.autograd.grad(F.linear(x, w), (x, w), g.to(dtype))
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    torch.testing.assert_close(dx, gx, rtol=0, atol=0)
    torch.testing.assert_close(dw, gw, rtol=0, atol=0)


def test_int8_forward_runs_the_six_projections(layer_reference):
    mcfg, tree, batch, _, _ = layer_reference
    trainer = _port_trainer("layer", tree, mcfg, int8_forward=True)
    before = tq.qdot.calls
    trainer.step(*batch[:3], CW, valid=batch[3])
    # six products a layer, each run again by the layer's checkpoint
    assert tq.qdot.calls - before == 6 * mcfg.num_hidden_layers * 2


def _jax_grads(jt, batch, mcfg):
    """JAX's loss and gradients of one ``step`` (dropout and SpecAugment
    off), under the port's parameter names."""
    from stutter_tpu.train.heads import weighted_softmax_xent

    waves, lengths, labels, valid = batch

    def loss_fn(p):
        logits = jft.finetune_forward(p, waves, lengths, jt.cfg, train=True,
                                      rng=jax.random.key(1))
        return weighted_softmax_xent(logits, labels, jnp.asarray(CW), valid=jnp.asarray(valid))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jt.params)
    return finetune_params_from_numpy(jax.tree.map(np.asarray, grads), mcfg), float(loss)


def test_int8_forward_step_matches_jax(layer_reference):
    """The loss and every trained leaf's gradient of one int8_forward step
    against JAX's int8_forward gradients, then the parameters after AdamW
    at the plain f32 step's bar."""
    mcfg, _, batch, _, _ = layer_reference
    jt, tt, tree = _pair(mcfg, int8_forward=True)
    ref, loss_j = _jax_grads(jt, batch, mcfg)
    grads, loss = _grads(tt, batch)
    assert loss == pytest.approx(loss_j, rel=INT8_LOSS_RTOL, abs=0)
    assert grads and set(grads) <= set(ref)
    top = max(float(g.abs().max()) for n, g in ref.items() if n in grads)
    for n, g in grads.items():
        if n.endswith("attention.k_b"):
            assert max(float(g.abs().max()), float(ref[n].abs().max())) <= K_B_NOISE * top, n
            continue
        rel = float(torch.linalg.vector_norm(g - ref[n]) / torch.linalg.vector_norm(ref[n]))
        assert rel <= INT8_GRAD_REL, (n, rel)
    waves, lengths, labels, valid = batch
    aux_j = jt.step(waves, lengths, labels, CW, valid=valid)
    aux_t = tt.step(waves, lengths, labels, CW, valid=valid)
    np.testing.assert_allclose(aux_t["loss"], aux_j["loss"], rtol=INT8_LOSS_RTOL)
    _assert_params_close(_tree(tt, mcfg), flatten_tree(jax.tree.map(np.asarray, jt.params)),
                         tt.cfg.backbone_lr)
    # the int8 projections trained
    assert not np.array_equal(_tree(tt, mcfg)["backbone/encoder/layers/ff_w1"],
                              flatten_tree(tree)["backbone/encoder/layers/ff_w1"])


def test_cast_params_false_with_bf16_still_raises():
    cfg = dataclasses.replace(_configs(_tiny(), "bf16")[1], cast_params=False)
    with pytest.raises(NotImplementedError, match="cast_params=False"):
        cfg.check_supported()
