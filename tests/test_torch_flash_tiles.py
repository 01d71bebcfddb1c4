"""What ``ops/flash_mha.py`` decides in Python for the bf16 wgmma tiles, with
no card present, and its plain versions against the JAX package at the ragged
lengths those tiles make risky (around their 64- and 128-row edges).

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` ([mha],
[mha_bias], [mha_edges]) holds them to the plain versions checked here, at
these lengths and key counts among others.

Bars:
- ``flash_mha_reference`` against the JAX einsum path (``mha_self`` with
  ``allow_flash=False``, HIGHEST precision), f32: 1e-6 max-abs, the bar of
  ``tests/test_torch_whisper.py``; a clip with no valid key gives the mean of
  its v on both sides.
- ``flash_mha_bias_reference`` against the JAX Pallas kernel in interpret
  mode: f32 2e-6 max-abs, bf16 cosine 1e-5 and one bf16 step, the bars of
  ``tests/test_torch_flash_bias.py``. Every clip keeps a valid key: the JAX
  function pads L to its block with ab = -1e9, which a row whose real keys
  all sit at -1e9 would attend to, where the port's kernels score keys past
  L as -inf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import stutter_tpu.models.attention as jattention
from stutter_tpu_torch.cli import flash_tiles_ab
from stutter_tpu_torch.ops import flash_mha as tmha
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

HIGHEST = jax.lax.Precision.HIGHEST
RAGGED = (64, 65, 127, 129)


def _qkv(L, dtype=torch.bfloat16, layout="transposed", d=64, B=2, H=3):
    """q, k, v as the models pass them ([B, L, H, d] projections viewed
    [B, H, L, d]) or contiguous [B, H, L, d]."""
    if layout == "transposed":
        return tuple(torch.zeros(B, L, H, d, dtype=dtype).transpose(1, 2) for _ in range(3))
    return tuple(torch.zeros(B, H, L, d, dtype=dtype) for _ in range(3))


@pytest.mark.parametrize("L", [37, 64, 65, 127, 128, 129, 1008, 1500, 1504])
@pytest.mark.parametrize("layout", ["transposed", "contiguous"])
def test_bf16_goes_to_the_wgmma_tiles_at_any_length(L, layout):
    assert tmha.device_path(*_qkv(L, layout=layout)) == tmha.BF16_TILES


@pytest.mark.parametrize("case", ["ragged", "encoder", "odd_offset", "odd_stride"])
def test_f32_goes_to_the_scalar_tiles(case):
    if case == "odd_offset":  # f32 rows need no 16-byte alignment
        q, k, v = (torch.zeros(2 * 37 * 3 * 64 + 1)[1:].view(2, 37, 3, 64).transpose(1, 2)
                   for _ in range(3))
    elif case == "odd_stride":
        q, k, v = (torch.zeros(2, 37, 3, 67)[..., :64].transpose(1, 2) for _ in range(3))
    else:
        q, k, v = _qkv(37 if case == "ragged" else 1500, dtype=torch.float32)
    assert tmha.device_path(q, k, v) == tmha.F32_TILES


def _misaligned_bf16(case):
    if case == "offset":  # 2 bytes off a 16-byte boundary
        return tuple(torch.zeros(2 * 64 * 3 * 64 + 1, dtype=torch.bfloat16)[1:]
                     .view(2, 64, 3, 64).transpose(1, 2) for _ in range(3))
    # rows of 68 elements: 136-byte pitch
    return tuple(torch.zeros(2, 64, 3, 68, dtype=torch.bfloat16)[..., :64].transpose(1, 2)
                 for _ in range(3))


@pytest.mark.parametrize("case,error,match", [
    ("offset", ValueError, "16-byte"),
    ("row_pitch", ValueError, "16-byte"),
    ("float16", TypeError, "float32 or bfloat16"),
    ("head_dim_32", ValueError, "head_dim 64"),
    ("k_strides", ValueError, "strides"),
    ("k_shape", ValueError, "k is"),
    ("strided_head_dim", ValueError, "contiguous"),
    ("three_dims", ValueError, r"\[B, H, L, d\]"),
])
def test_what_neither_tile_set_takes_raises(case, error, match):
    if case in ("offset", "row_pitch"):
        q, k, v = _misaligned_bf16(case)
    elif case == "float16":
        q, k, v = _qkv(64, dtype=torch.float16)
    elif case == "head_dim_32":
        q, k, v = _qkv(64, d=32)
    elif case == "k_strides":
        q, _, v = _qkv(64)
        k = _qkv(64, layout="contiguous")[0]
    elif case == "k_shape":
        q, _, v = _qkv(64)
        k = _qkv(65)[0]
    elif case == "strided_head_dim":
        q, k, v = (torch.zeros(2, 3, 64, 128, dtype=torch.bfloat16)[..., ::2] for _ in range(3))
    else:
        q, k, v = (t[0] for t in _qkv(64))
    with pytest.raises(error, match=match):
        tmha.device_path(q, k, v)


@pytest.mark.parametrize("L,shift,expect", [
    (1008, 0, 16), (1504, 0, 16), (64, 0, 16), (128, 0, 16),  # the hatch's buckets: vectors
    (65, 0, 4), (127, 0, 4), (129, 0, 4), (37, 0, 4),          # ragged rows: element-wise
    (1008, 1, 4), (64, 1, 4),                                   # aligned rows off an aligned base
    (64, 4, 16),                                                # 16 bytes off: still aligned
])
def test_ab_vector_bytes(L, shift, expect):
    ab = torch.zeros(2 * L * L + shift)[shift:].view(1, 2, L, L)
    assert ab.is_contiguous()
    assert tmha.ab_vector_bytes(ab) == expect


@pytest.mark.parametrize("L", RAGGED)
def test_wrappers_refuse_cpu_tensors_with_no_card(monkeypatch, L):
    """A CPU tensor never reaches a kernel, and never the plain version
    through the kernel wrappers; ``mha_self`` alone sends it to the plain
    version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = np.random.RandomState(L)
    q, k, v = (torch.from_numpy(r.randn(1, 2, L, 64).astype(np.float32)).bfloat16()
               for _ in range(3))
    before = (tmha.flash_mha.launches, tmha.flash_mha_bias.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tmha.flash_mha(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tmha.flash_mha_bias(q, k, v, torch.zeros(1, 2, L, L))
    assert (tmha.flash_mha.launches, tmha.flash_mha_bias.launches) == before
    out = tmha.mha_self(q, k, v)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tmha.flash_mha_reference(q, k, v))


def test_ab_script_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash_tiles_ab.main([])


@pytest.mark.parametrize("L", RAGGED)
@pytest.mark.parametrize("first_valid", [0, 1, "L"])
def test_mha_reference_matches_jax_einsum_at_ragged_lengths(L, first_valid):
    """Three clips: `first_valid` keys, all L, and L - 1."""
    r = np.random.RandomState(1000 + L)
    q, k, v = (r.randn(3, 2, L, 64).astype(np.float32) * 0.3 for _ in range(3))
    kv = np.asarray([L if first_valid == "L" else first_valid, L, L - 1], np.int32)
    ref = np.asarray(jattention.mha_self(*map(jnp.asarray, (q, k, v)), kv_valid=jnp.asarray(kv),
                                         precision=HIGHEST, allow_flash=False))
    ours = tmha.flash_mha_reference(*map(torch.from_numpy, (q, k, v)),
                                    torch.from_numpy(kv)).numpy()
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    if first_valid == 0:  # no valid key: every key at -1e9, the mean of v
        np.testing.assert_allclose(ours[0], np.broadcast_to(v[0].mean(1, keepdims=True),
                                                             ours[0].shape), atol=1e-6, rtol=0)


@pytest.mark.parametrize("L", RAGGED)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bias_reference_matches_jax_pallas_at_ragged_lengths(L, dtype):
    """Two clips: one with a single valid key (the rest masked in ab), one
    with all L."""
    r = np.random.RandomState(2000 + L)
    q, k, v = (r.randn(2, 2, L, 64).astype(np.float32) * 0.3 for _ in range(3))
    if dtype == "bf16":  # bf16-representable, so both sides see the same values
        q, k, v = (np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32) for t in (q, k, v))
    ab = (r.rand(2, 2, L, 1) * r.randn(1, 2, L, L)).astype(np.float32)
    ab[0, :, :, 1:] += -1e9
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jattention.flash_mha_bias(
            *(jnp.asarray(t, jdt) for t in (q, k, v)), jnp.asarray(ab)), np.float32)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    ours = tmha.flash_mha_bias_reference(*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                                         torch.from_numpy(ab))
    assert ours.dtype == tdt and tuple(ours.shape) == ref.shape == (2, 2, L, 64)
    ours = ours.float().numpy()
    # the clip with one valid key returns that key's v
    np.testing.assert_allclose(ours[0], np.broadcast_to(v[0][:, :1], ours[0].shape),
                               atol=1e-6, rtol=0)
    max_abs, cos = float(np.abs(ours - ref).max()), cosine_distance(ours, ref)
    if dtype == "f32":
        assert max_abs <= 2e-6
    else:
        assert cos <= 1e-5
        assert max_abs <= 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))
