"""The port's attention backward against the JAX package's Pallas VJP.

``stutter_tpu_torch.ops.wavlm_attention``'s plain backward (what the CPU path
runs, and what the CUDA backward kernels are held to on the card) against
``jax.vjp`` of ``wavlm_attention_long_diff`` / ``wavlm_attention_short_diff``
in interpret mode, on the same numpy inputs, at the sizes of
``tests/test_attention_vjp.py``; gradcheck of the autograd Function; the
wrappers' launch counts and input checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stutter_tpu.ops.wavlm_attention_vjp import (
    wavlm_attention_long_diff,
    wavlm_attention_short_diff,
)
from stutter_tpu_torch.ops import wavlm_attention as tattn

torch.set_num_threads(2)  # six xdist workers share the host

REL_TOL = 3e-5  # of each gradient's max, as tests/test_attention_vjp.py


def _inputs(B, H, L, d, seed, full_pad=False):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, L, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, H, L, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, H, L, d)).astype(np.float32)
    pb = rng.standard_normal((H, L, L)).astype(np.float32)
    gate = rng.uniform(0.5, 2.0, (B, H, L)).astype(np.float32)
    mask = np.zeros((B, L), np.float32)
    mask[0, L - 37:] = -1e9  # one partially padded clip
    if full_pad:
        mask[-1] = -1e9  # and one fully padded clip
    cot = rng.standard_normal((B, H, L, d)).astype(np.float32)
    return (q, k, v, pb, gate, mask), cot


@pytest.mark.parametrize("variant,B,L,block_q,full_pad", [
    ("long", 2, 256, 128, False),
    ("long", 1, 384, 384, False),   # the backward halves its block: 384 -> 128
    ("short", 4, 128, None, True),
], ids=["long_256", "long_384_block_halving", "short_128_padded_clip"])
def test_plain_backward_matches_jax_vjp(variant, B, L, block_q, full_pad):
    args, cot = _inputs(B, 2, L, 64, seed=L + B, full_pad=full_pad)

    def f(q, k, v, pb, gate):
        if variant == "long":
            return wavlm_attention_long_diff(q, k, v, pb, gate, jnp.asarray(args[5]),
                                             block_q=block_q, interpret=True)
        return wavlm_attention_short_diff(q, k, v, pb, gate, jnp.asarray(args[5]),
                                          interpret=True)

    out_j, vjp = jax.vjp(f, *map(jnp.asarray, args[:5]))
    grads_j = vjp(jnp.asarray(cot))
    t = [torch.from_numpy(a) for a in args]
    out = tattn.gated_relpos_attention(*t)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=2e-5, atol=2e-5)
    ours = tattn.gated_relpos_attention_backward(*t, out, torch.from_numpy(cot))
    # ours: dq, dk, dv, dbias, dgate; JAX: q, k, v, position_bias, gate
    for name, a, b in zip(("q", "k", "v", "position_bias", "gate"), ours, grads_j):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        denom = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=REL_TOL, atol=REL_TOL * denom,
                                   err_msg=f"gradient mismatch: {name}")


def test_function_gradients_match_plain_backward():
    """The autograd Function on the CPU hands back the plain backward."""
    args, cot = _inputs(2, 2, 48, 64, seed=3, full_pad=True)
    t = [torch.from_numpy(a).requires_grad_(i < 5) for i, a in enumerate(args)]
    out = tattn.GatedRelPosAttentionFn.apply(*t)
    grads = torch.autograd.grad(out, t[:5], torch.from_numpy(cot))
    ref = tattn.gated_relpos_attention_backward_reference(
        *(a.detach() for a in t), out.detach(), torch.from_numpy(cot))
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    B, H, L, d = 2, 2, 7, 64
    q, k, v = (torch.randn(B, H, L, d, generator=g, dtype=torch.float64).requires_grad_()
               for _ in range(3))
    bias = torch.randn(H, L, L, generator=g, dtype=torch.float64).requires_grad_()
    gate = torch.rand(B, H, L, generator=g, dtype=torch.float64).requires_grad_()
    mask = torch.zeros(B, L, dtype=torch.float64)
    mask[1, 4:] = -1e9
    assert torch.autograd.gradcheck(
        lambda *a: tattn.GatedRelPosAttentionFn.apply(*a, mask), (q, k, v, bias, gate))


def test_row_stats_of_the_cpu_forward():
    """The [2, B, H, L] statistics the forward writes: the row max and the
    log-sum kept apart, so a fully padded clip keeps its log(L)."""
    args, _ = _inputs(2, 2, 40, 64, seed=4, full_pad=True)
    t = [torch.from_numpy(a) for a in args]
    stats = torch.empty(2, 2, 2, 40)
    tattn.gated_relpos_attention(*t, stats)
    s = (t[0] @ t[1].transpose(-1, -2) + t[4][..., None] * t[3][None]
         + t[5][:, None, None, :]).double()
    torch.testing.assert_close(stats[0].double(), s.amax(-1), rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(stats[0].double() + stats[1].double(),
                               torch.logsumexp(s, -1), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(stats[1, -1].numpy(), np.log(40.0), rtol=1e-6)


def test_cpu_path_leaves_launches_at_zero():
    args, cot = _inputs(2, 2, 16, 64, seed=5)
    t = [torch.from_numpy(a).requires_grad_(i < 5) for i, a in enumerate(args)]
    out = tattn.gated_relpos_attention_diff(*t)
    out.backward(torch.from_numpy(cot))
    assert tattn.gated_relpos_attention.launches == 0
    assert tattn.gated_relpos_attention_backward.launches == 0


@pytest.mark.parametrize("fault", ["dtype", "gate_shape", "strides", "row_stats_shape",
                                   "row_stats_missing", "grad_out_shape"])
def test_backward_input_checks(fault, monkeypatch):
    """The CUDA wrapper's checks, run on CPU tensors presented as the card's."""
    B, H, L, d = 2, 3, 10, 64
    q, k, v, out, do = (torch.zeros(B, H, L, d) for _ in range(5))
    bias, gate, mask = torch.zeros(H, L, L), torch.zeros(B, H, L), torch.zeros(B, L)
    stats = torch.zeros(2, B, H, L)
    if fault == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif fault == "gate_shape":
        gate = torch.zeros(B, H, L + 1)
    elif fault == "strides":
        k = torch.zeros(B, L, H, d).transpose(1, 2)
    elif fault == "row_stats_shape":
        stats = torch.zeros(2, B, H, L + 1)
    elif fault == "row_stats_missing":
        stats = None
    else:
        do = torch.zeros(B, H, L + 1, d)
    monkeypatch.setattr(tattn, "_device_kind", lambda q: "cuda")
    with pytest.raises((ValueError, TypeError)):
        tattn.gated_relpos_attention_backward(q, k, v, bias, gate, mask, out, do, stats)
    assert tattn.gated_relpos_attention_backward.launches == 0


def test_other_devices_raise():
    q = torch.zeros(1, 1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tattn.gated_relpos_attention_backward(q, q, q, None, None, None, q, q)
