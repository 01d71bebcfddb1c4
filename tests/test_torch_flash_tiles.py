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

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import stutter_tpu.models.attention as jattention
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


def test_chip_smoke_needs_a_card(monkeypatch, capsys):
    """The card check refuses to run with no card rather than fall back to
    the CPU."""
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() == 1
    assert "no CUDA device" in capsys.readouterr().err


# the mangled names of the kernels whose ptxas rows chip_smoke.py reads, as
# nvcc 12.8 printed them for sm_90a; then two it must leave out (f32 tiles)
_PTXAS_KERNELS = [
    "_ZN4sm9021attention_bf16_kernelIN45_GLOBAL__N__89d3f55a_12_flash_mha_cu_03f1aa2010Key"
    "PaddingELi120ELi2ELi4ELi1ELi0EEEvPK13__nv_bfloat16S5_S5_NT_6ParamsEPS3_Pfiiiiixxx",
    "_ZN4sm9021attention_bf16_kernelIN45_GLOBAL__N__89d3f55a_12_flash_mha_cu_03f1aa2010Key"
    "PaddingELi64ELi2ELi4ELi2ELi0EEEvPK13__nv_bfloat16S5_S5_NT_6ParamsEPS3_Pfiiiiixxx",
    "_ZN4sm9021attention_bf16_kernelIN45_GLOBAL__N__89d3f55a_12_flash_mha_cu_03f1aa208Full"
    "BiasELi64ELi2ELi4ELi1ELi0EEEvPK13__nv_bfloat16S5_S5_NT_6ParamsEPS3_Pfiiiiixxx",
    *("_ZN4sm9021attention_bf16_kernelIN51_GLOBAL__N__a806e445_18_wavlm_attention_cu_e73ede5a"
      f"13GatedBiasRingELi64ELi1ELi3ELi2ELi{order}EEEvPK13__nv_bfloat16S5_S5_NT_6ParamsEPS3_"
      "Pfiiiiixxx" for order in (0, 1)),
    "_ZN4sm9021attention_bf16_kernelIN52_GLOBAL__N__32e9d357_19_relkey_attention_cu_197da236"
    "11RelKeyTableI13__nv_bfloat16EELi64ELi2ELi4ELi2ELi0EEEvPKS3_S6_S6_NT_6ParamsEPS3_"
    "Pfiiiiixxx",
    *(f"_ZN55_GLOBAL__N__be996e00_22_wavlm_attention_bwd_cu_8fd40e8c{part}_bf16_kernelILi"
      f"{order}EEEvNS_7BwdArgsEii" for part in ("18bwd_dq", "19bwd_dkv") for order in (0, 1)),
    "_ZN55_GLOBAL__N__be996e00_22_wavlm_attention_bwd_cu_8fd40e8c21bwd_dbias_bf16_kernelENS_7"
    "BwdArgsEiiiPf",
    *(f"_ZN46_GLOBAL__N__ce95eed6_13_wavlm_stem_cu_5bff1e5316stem_conv_kernelILi{taps}EEEv14"
      "CUtensorMap_stPK13__nv_bfloat16PKfPS2_iii" for taps in (2, 3)),
    *(f"_ZN44_GLOBAL__N__b5f12560_11_pos_conv_cu_315cbbe415pos_conv_kernelILi{cg}EEEvPK13__nv_"
      "bfloat16S3_PKfPS1_iiii" for cg in (64, 120)),
    "_ZN47_GLOBAL__N__f6e91de3_14_attn_probes_cu_0550803e16attn_int8_kernelEPK13__nv_bfloat16PK"
    "aPKfS4_S6_NS_11ProbeParamsEPS0_iiiiii",
    "_ZN47_GLOBAL__N__f6e91de3_14_attn_probes_cu_0550803e18quantize_kv_kernelEPK13__nv_bfloat16"
    "S2_PaPfS3_S4_ii",
    *(f"_ZN47_GLOBAL__N__f6e91de3_14_attn_probes_cu_0550803e22softmax_variant_kernelILb{a}ELb{b}"
      "EEEvPK13__nv_bfloat16S3_S3_NS_11ProbeParamsEPS1_iiiii" for a in (0, 1) for b in (0, 1)),
    "_ZN45_GLOBAL__N__89d3f55a_12_flash_mha_cu_03f1aa2020attention_f32_kernelINS_10KeyPadding"
    "ELi64EEEvPKfS3_S3_NT_6ParamsEPfS6_iiixxx",
    "_ZN55_GLOBAL__N__be996e00_22_wavlm_attention_bwd_cu_8fd40e8c13dq_f32_kernelENS_7BwdArgsE",
]


@pytest.mark.parametrize("fault", [None, "spill", "stack", "missing", "serialised"])
def test_tile_resources_read_every_instantiation(monkeypatch, tmp_path, capsys, fault):
    """chip_smoke.py's [ptxas] check names each bf16 kernel of a ptxas report
    by its tiles and passes a clean build; a spill, a stack frame, a missing
    instantiation or a serialised wgmma fails it."""
    import chip_smoke
    from stutter_tpu_torch.ops import _build

    kernels = _PTXAS_KERNELS[1:] if fault == "missing" else _PTXAS_KERNELS
    entries = []
    for i, name in enumerate(kernels):
        stack, spill = (16 if fault == "stack" and i == 5 else 0,
                        8 if fault == "spill" and i == 9 else 0)
        entries.append(
            f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {stack} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
            f"ptxas info    : Used {100 + i} registers, used 1 barriers\n")
    if fault == "serialised":
        entries.append("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
                       "instructions are serialized due to the presence of Extern calls\n")
    (tmp_path / "lib.ptxas.txt").write_text("".join(entries))
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(chip_smoke, "probe_sass", lambda path: [])
    if fault is None:
        chip_smoke.phase_tile_resources(_build)
        named = re.findall(r"^\[ptxas\] kernel=(.*) registers=", capsys.readouterr().out, re.M)
        assert named == [
            "attention_bf16_kernel<KeyPadding<120, 2, 4, 1, 0>>",
            "attention_bf16_kernel<KeyPadding<64, 2, 4, 2, 0>>",
            "attention_bf16_kernel<FullBias<64, 2, 4, 1, 0>>",
            "attention_bf16_kernel<GatedBiasRing<64, 1, 3, 2, 0>>",
            "attention_bf16_kernel<GatedBiasRing<64, 1, 3, 2, 1>>",
            "attention_bf16_kernel<RelKeyTable<64, 2, 4, 2, 0>>",
            "bwd_dq<0>", "bwd_dq<1>", "bwd_dkv<0>", "bwd_dkv<1>", "bwd_dbias",
            "stem_conv<2>", "stem_conv<3>", "pos_conv<64>", "pos_conv<120>",
            "probe_attn_int8", "probe_quantize_kv", "probe_softmax_variant<0, 0>",
            "probe_softmax_variant<0, 1>", "probe_softmax_variant<1, 0>",
            "probe_softmax_variant<1, 1>"]
    else:
        with pytest.raises(chip_smoke.CheckFailed):
            chip_smoke.phase_tile_resources(_build)


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
