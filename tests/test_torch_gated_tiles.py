"""What ``ops/wavlm_attention.py`` decides in Python for the gated attention's
bf16 wgmma tiles, with no card present, and its plain versions against the
JAX package's Pallas kernels at head_dim 64 and the ragged lengths those
tiles make risky (around their 64- and 128-row edges, and the 3 s bucket).

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` ([kernel],
[gated_edges], [attn_bwd]) holds it, output and row statistics, to the plain
versions checked here.

Bars:
- ``gated_relpos_attention_reference`` against ``wavlm_fused_attention``
  (short kernel) or ``wavlm_fused_attention_long`` (long kernel, where L has
  a block of a multiple of 8 rows below L) in interpret mode: f32 2e-5
  max-abs (``tests/test_torch_wavlm.py``'s bar), bf16 cosine distance 1e-5
  (the JAX kernels round the probabilities to bf16 before p . v, the plain
  version keeps them f32).
- The row statistics: exp(s - max - log-sum) against the plain softmax to
  1e-6 (f32 ulps of probabilities at most 1); a fully padded clip gives the
  mean of its v.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stutter_tpu.ops.wavlm_attention_pallas import (
    wavlm_fused_attention,
    wavlm_fused_attention_long,
)
from stutter_tpu_torch.cli import flash_tiles_ab
from stutter_tpu_torch.ops._attention import vector_bytes
from stutter_tpu_torch.ops import wavlm_attention as tattn
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

LENGTHS = (37, 63, 64, 65, 127, 128, 129, 160)
F32_MAX_ABS, BF16_COSINE = 2e-5, 1e-5


def _inputs(L, seed, B=3, H=2, d=64):
    """Clip 0 has 2/3 of its keys, clip 1 none, clip 2 all of them and a gate
    of 0."""
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, L, d).astype(np.float32) * 0.3 for _ in range(3))
    bias = rng.randn(H, L, L).astype(np.float32)
    gate = rng.uniform(0.0, 2.0, (B, H, L)).astype(np.float32)
    gate[2] = 0.0
    mask = np.zeros((B, L), np.float32)
    mask[0, (2 * L) // 3:] = -1e9
    mask[1] = -1e9
    return q, k, v, bias, gate, mask


def _long_block(L):
    """A block of the long kernel for L (a multiple of 8 that divides L and
    is below it), or None: those lengths go to the short kernel."""
    return next((bq for bq in (64, 32, 16, 8) if bq < L and L % bq == 0), None)


def _torch_args(args, dtype):
    q, k, v, *rest = (torch.from_numpy(a) for a in args)
    return (q.to(dtype), k.to(dtype), v.to(dtype), *rest)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", LENGTHS)
def test_plain_version_matches_the_jax_kernels(L, dtype):
    args = _inputs(L, seed=L)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jargs = [jnp.asarray(a, jdt) for a in args[:3]] + [jnp.asarray(a) for a in args[3:]]
    block = _long_block(L)
    if block is None:
        ref = wavlm_fused_attention(*jargs, interpret=True)
    else:
        ref = wavlm_fused_attention_long(*jargs, block_q=block, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    ours = tattn.gated_relpos_attention_reference(*_torch_args(args, getattr(torch, dtype)))
    ours = ours.float().numpy()
    assert np.isfinite(ours).all()
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, atol=F32_MAX_ABS)
    else:
        assert cosine_distance(ours, ref) <= BF16_COSINE
    # the fully padded clip attends to every key alike: the mean of its v
    v_mean = _torch_args(args, getattr(torch, dtype))[2][1].float().mean(dim=1, keepdim=True)
    np.testing.assert_allclose(ours[1], np.broadcast_to(v_mean.numpy(), ours[1].shape),
                               atol=1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", (37, 64, 129, 160))
def test_row_statistics_reproduce_the_softmax(L, dtype):
    """What the epilogue writes, by the plain version the CPU wrapper copies:
    exp(s - m - logl) is the softmax, also at -1e9, where m + logl would
    round back to m."""
    args = _torch_args(_inputs(L, seed=100 + L), dtype)
    q, k, v, bias, gate, mask = args
    B, H = q.shape[:2]
    stats = torch.empty(2, B, H, L)
    out = tattn.gated_relpos_attention(*args, row_stats=stats)
    s = tattn._scores(q, k, bias, gate, mask)
    p = torch.exp((s - stats[0][..., None]) - stats[1][..., None])
    torch.testing.assert_close(p, torch.softmax(s, dim=-1), atol=1e-6, rtol=0)
    assert torch.equal(stats[0][1], s[1].amax(dim=-1))  # the padded clip's max: -1e9 ...
    torch.testing.assert_close(stats[1][1], torch.full((H, L), float(np.log(L))))  # ... log L
    torch.testing.assert_close((p @ v.float())[1], v.float()[1].mean(dim=1, keepdim=True)
                               .expand(H, L, 64), atol=1e-6, rtol=0)
    torch.testing.assert_close(out, tattn.gated_relpos_attention_reference(*args), atol=0,
                               rtol=0)


@pytest.mark.parametrize("L", (37, 63, 64, 65, 127, 128, 129, 160, 1008, 1504))
@pytest.mark.parametrize("layout", ["transposed", "contiguous"])
def test_bf16_goes_to_the_wgmma_tiles_and_f32_to_the_scalar_tiles(L, layout):
    shape = (2, L, 3, 64) if layout == "transposed" else (2, 3, L, 64)
    for dtype, tiles in ((torch.bfloat16, tattn.BF16_TILES), (torch.float32, tattn.F32_TILES)):
        q, k, v = (torch.zeros(shape, dtype=dtype) for _ in range(3))
        if layout == "transposed":
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        assert tattn.device_path(q, k, v) == tiles


@pytest.mark.parametrize("H,L,order", [
    (16, 64, "query_tile"), (16, 112, "query_tile"), (16, 160, "query_tile"),  # 1-3 s buckets
    (16, 256, "query_tile"), (16, 400, "query_tile"),                          # 5 s, 8 s
    (16, 512, "query_tile"), (16, 513, "clip"),         # the plane passes 16 MiB
    (16, 608, "clip"), (16, 1008, "clip"), (16, 1504, "clip"),                 # 12-30 s
    (12, 591, "query_tile"), (12, 592, "clip"),         # WavLM-Base's 12 heads
])
def test_grid_order_by_the_bias_plane_size(H, L, order):
    expect = {"query_tile": tattn.QUERY_TILE_FASTEST, "clip": tattn.CLIP_FASTEST}[order]
    assert tattn.grid_order_for(H, L) == expect


@pytest.mark.parametrize("L,bias_shift,mask_shift,expect", [
    (160, 0, 0, 16), (1008, 0, 0, 16), (1504, 0, 0, 16), (64, 0, 0, 16),  # main-path buckets
    (37, 0, 0, 4), (65, 0, 0, 4), (63, 0, 0, 4), (129, 0, 0, 4),          # L % 4 != 0
    (160, 1, 0, 4), (1008, 0, 1, 4),                                      # a misaligned base
    (160, 4, 4, 16),                                                      # 16 bytes off: aligned
])
def test_bias_and_mask_vector_bytes(L, bias_shift, mask_shift, expect):
    bias = torch.zeros(2 * L * L + bias_shift)[bias_shift:].view(2, L, L)
    mask = torch.zeros(3 * L + mask_shift)[mask_shift:].view(3, L)
    assert bias.is_contiguous() and mask.is_contiguous()
    assert vector_bytes(bias, mask) == expect


def test_cpu_tensors_take_the_plain_version_and_never_a_kernel(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _torch_args(_inputs(65, seed=7), torch.bfloat16)
    before = tattn.gated_relpos_attention.launches
    out = tattn.gated_relpos_attention(*args)
    assert tattn.gated_relpos_attention.launches == before
    assert torch.equal(out, tattn.gated_relpos_attention_reference(*args))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.launch_tiles(*args, None, tattn.CLIP_FASTEST)


def test_ab_tool_raises_for_the_gated_kernel_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_tiles_ab.main(["--kernels", "gated", "--skip_timing"])
