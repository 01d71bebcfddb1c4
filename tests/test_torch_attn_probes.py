"""The port's attention probes against the JAX probe kernels, on the CPU.

``scripts/attn_int8_probe.py`` and ``scripts/attn_softmax_variants_probe.py``
define their Pallas kernels inside ``main()``, so the tests run the scripts
as they are (``runpy``, ``--cases 376,1 --iters 1 --loops 1``) in TPU
interpret mode, with ``pallas_call`` wrapped so that each kernel's output is
sent to the host (the scripts call their kernels under ``jax.jit``). The
inputs are remade from ``RandomState(0)`` in the scripts' order and go
through the port's plain versions (``ops/attn_probes.py:*_reference``),
which the CUDA kernels are held to on the card by ``chip_smoke.py``.

Bars, cosine distance against the captured JAX output, about 10x the
distances measured when the plain versions were written:
- int8, 1e-4 (8.7e-6 measured): q, k and v quantise to the same int8 values,
  but the f32 softmax sums in another order, so a rare probability sits on
  the other side of a round-half boundary of round(a * 127) and moves one
  int8 step (7.2e-3 of an output whose max is 0.19);
- variants A and B, 1e-6 (~2e-9): the same f32 chain and the same bf16
  roundings of the probabilities, sums in another order;
- variants C and D, 1e-5 (<= 4.5e-7): XLA may keep some of the bf16 chain's
  intermediates in f32 (excess precision inside its fusions), where the
  plain version rounds after every operation as the probe's source reads.
"""

import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stutter_tpu_torch.cli import attn_int8_probe, attn_softmax_variants_probe
from stutter_tpu_torch.ops import attn_probes
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

REPO = Path(__file__).resolve().parents[1]
L, B, H, D = 376, 1, 16, 64
INT8_COSINE = 1e-4
VARIANT_COSINE = {"A_incumbent": 1e-6, "B_postnorm": 1e-6, "C_bf16chain": 1e-5,
                  "D_both": 1e-5}


def _captured_kernel_outputs(monkeypatch, script: str) -> list:
    """Run a probe script at one small case in interpret mode; the output of
    every pallas_call it makes, in the order they ran."""
    captured = []
    real = pl.pallas_call

    def spy(*args, **kwargs):
        kernel = real(*args, **kwargs)

        def call(*operands):
            out = kernel(*operands)
            jax.debug.callback(lambda x: captured.append(np.asarray(x, np.float32)), out)
            return out
        return call

    monkeypatch.setattr(pl, "pallas_call", spy)
    monkeypatch.setattr(sys, "argv", [script, "--cases", f"{L},{B}", "--iters", "1",
                                      "--loops", "1"])
    jax.clear_caches()
    with pltpu.force_tpu_interpret_mode():
        runpy.run_path(str(REPO / "scripts" / script), run_name="__main__")
    jax.effects_barrier()
    return captured


def _probe_inputs():
    """The scripts' inputs: RandomState(0), q, k, v, bias, gate, zero mask."""
    rs = np.random.RandomState(0)

    def mk(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * 0.3).to(torch.bfloat16)

    q, k, v = mk(B, H, L, D), mk(B, H, L, D), mk(B, H, L, D)
    bias = torch.from_numpy(rs.randn(H, L, L).astype(np.float32))
    gate = torch.from_numpy(rs.rand(B, H, L).astype(np.float32))
    return q, k, v, bias, gate, torch.zeros((B, L))


def test_int8_reference_matches_jax_probe(monkeypatch):
    captured = _captured_kernel_outputs(monkeypatch, "attn_int8_probe.py")
    ours = attn_probes.int8_attention_long_reference(*_probe_inputs()).float().numpy()
    assert captured[0].shape == ours.shape == (B, H, L, D)
    dist = cosine_distance(ours, captured[0])
    print(f"int8 probe: port plain version vs JAX Pallas kernel, cosine {dist:.3e}")
    assert dist <= INT8_COSINE


@pytest.fixture(scope="module")
def variant_captures():
    with pytest.MonkeyPatch.context() as mp:
        return _captured_kernel_outputs(mp, "attn_softmax_variants_probe.py")


@pytest.mark.parametrize("index,name", enumerate(attn_probes.VARIANTS))
def test_variant_reference_matches_jax_probe(variant_captures, index, name):
    # each variant ran twice, by its direct call and by its timing function
    jax_out = variant_captures[2 * index]
    ours = attn_probes.softmax_variant_attention_reference(
        *_probe_inputs(), *attn_probes.VARIANTS[name]).float().numpy()
    assert jax_out.shape == ours.shape == (B, H, L, D)
    dist = cosine_distance(ours, jax_out)
    print(f"{name}: port plain version vs JAX Pallas kernel, cosine {dist:.3e}")
    assert dist <= VARIANT_COSINE[name]


def test_quantize_kv_reference_scales():
    """Per-row k and per-column v: every int8 value within [-127, 127], each
    row's (column's) largest magnitude at 127, and the scales reproduce the
    inputs to half a step."""
    q, k, v, *_ = _probe_inputs()
    kq, sk, vq, sv = attn_probes.quantize_kv_reference(k, v)
    assert kq.dtype == vq.dtype == torch.int8 and sk.shape == (B, H, L) and sv.shape == (B, H, D)
    assert int(kq.abs().amax(-1).min()) == int(vq.abs().amax(-2).min()) == 127
    assert torch.all((kq.float() * sk[..., None] - k.float()).abs() <= 0.5001 * sk[..., None])
    assert torch.all((vq.float() * sv[..., None, :] - v.float()).abs() <= 0.5001 * sv[..., None, :])


@pytest.mark.parametrize("cli,keys", [
    (attn_int8_probe, ["B", "block_q", "int8_vs_f32_cosine", "bf16_vs_f32_cosine", "int8_ms",
                       "bf16_ms", "speedup_min"]),
    (attn_softmax_variants_probe, ["B", "block_q"] + [
        f"{n}_{s}" for n in attn_probes.VARIANTS for s in ("cosine", "ms")]
     + ["src_incumbent_ms"]),
])
def test_probe_cli_on_cpu(capsys, tmp_path, cli, keys):
    before = (attn_probes.int8_attention_long.launches,
              attn_probes.softmax_variant_attention.launches)
    out_path = tmp_path / "probe.json"
    assert cli.main(["--device", "cpu", "--cases", "40,2;64,1", "--iters", "1", "--loops", "2",
                     "--out", str(out_path)]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result == json.loads(out_path.read_text())
    assert result["device"] == "cpu" and set(result["cases"]) == {"L40", "L64"}
    for case in result["cases"].values():
        assert sorted(case) == sorted(keys)
        assert case["block_q"] == attn_probes.BLOCK_Q
        assert all(len(case[k]) == 2 for k in keys if k.endswith("_ms"))
        assert all(0 <= case[k] < 0.1 for k in keys if k.endswith("cosine"))
    assert (attn_probes.int8_attention_long.launches,
            attn_probes.softmax_variant_attention.launches) == before == (0, 0)


def test_probe_kernels_refuse_other_devices():
    args = [torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16, device="meta") for _ in range(3)]
    args += [torch.zeros(1, 8, 8), torch.zeros(1, 1, 8), torch.zeros(1, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        attn_probes.int8_attention_long(*args)
    with pytest.raises(ValueError, match="CUDA"):
        attn_probes.softmax_variant_attention(*args, True, False)
    with pytest.raises(ValueError, match="on the card"):
        attn_probes.quantize_kv(args[1], args[2])


def test_key_permutation_is_a_bijection_of_the_tile():
    """sigma is a bijection of the 64 keys of a tile, and it puts the key of
    score column c = 8 nt + 2 tig + j where the int8 A fragment of the second
    product wants it: with the lane (tig) that holds the column, in k-step
    nt // 4, register half (nt // 2) % 2, byte 2 (nt % 2) + j."""
    sigma = attn_probes.key_permutation()
    assert sorted(sigma) == list(range(attn_probes.KEY_ALIGN))
    for c, key in enumerate(sigma):
        nt, tig, j = c // 8, (c % 8) // 2, c % 2
        assert (key % 16) // 4 == tig
        assert key // 32 == nt // 4 and (key % 32) // 16 == (nt // 2) % 2
        assert key % 4 == 2 * (nt % 2) + j


@pytest.mark.parametrize("L", [192, 200])
def test_int8_reference_unchanged_under_key_permutation(L):
    """The int8 plain version gives the same output when every whole 64-key
    tile's keys (k, v, the bias columns and the mask) are taken in
    key_permutation's order, as the kernel stages them: the int8 products
    are exact and the softmax is a function of the set of keys."""
    rs = np.random.RandomState(3)
    Bc, Hc = 2, 2

    def mk(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * 0.3).to(torch.bfloat16)

    q, k, v = mk(Bc, Hc, L, D), mk(Bc, Hc, L, D), mk(Bc, Hc, L, D)
    bias = torch.from_numpy(rs.randn(Hc, L, L).astype(np.float32))
    gate = torch.from_numpy(rs.rand(Bc, Hc, L).astype(np.float32))
    mask = torch.zeros((Bc, L))
    mask[1, L // 2:] = -1e9
    sigma = torch.tensor(attn_probes.key_permutation())
    whole = L // 64 * 64
    order = torch.cat([t * 64 + sigma for t in range(L // 64)] + [torch.arange(whole, L)])
    assert sorted(order.tolist()) == list(range(L))
    ref = attn_probes.int8_attention_long_reference(q, k, v, bias, gate, mask)
    got = attn_probes.int8_attention_long_reference(
        q, k[:, :, order], v[:, :, order], bias[..., order], gate, mask[:, order])
    assert torch.equal(got, ref)


@pytest.mark.parametrize("L", [1, 37, 63, 64, 65, 129, 376])
def test_transpose_padded_reference_at_key_align(L):
    """The prologue's transposed int8 v: whole 64-key tiles, zeros past L,
    vq transposed below L."""
    rs = np.random.RandomState(L)
    v = torch.from_numpy(rs.randn(2, 3, L, D).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rs.randn(2, 3, L, D).astype(np.float32)).to(torch.bfloat16)
    _, _, vq, _ = attn_probes.quantize_kv_reference(k, v)
    vqt = attn_probes.transpose_padded_reference(vq)
    Lp = attn_probes.padded_length(L)
    assert attn_probes.KEY_ALIGN == 64 and Lp % 64 == 0 and L <= Lp < L + 64
    assert vqt.shape == (2, 3, D, Lp) and vqt.dtype == torch.int8
    assert not bool(vqt[..., L:].any())
    assert torch.equal(vqt[..., :L], vq.transpose(-1, -2))


# cuobjdump's layout: a kernel's name, then one instruction a line (address,
# optional predicate, opcode, operands), branch targets as addresses
_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_122softmax_variant_kernelILb1ELb0EEEvPK13__nv_bfloat16
	.headerflags	@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;              /* 0x00000a00ff017b82 */
                                                                       /* 0x000fe40000000800 */
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
        /*0020*/                   FFMA R2, R3, R4, R5 ;
{body}
        /*0f00*/              @!P0 BRA 0x20 ;
        /*0f10*/                   EXIT ;
        /*0f20*/                   BRA 0xf20;
		Function : _ZN12_GLOBAL__N_116attn_int8_kernelEPK13__nv_bfloat16
        /*0000*/                   IGMMA.64x64x32.S8.S8 R24, R8, gdesc[UR4], RZ ;
        /*0010*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_118quantize_kv_kernelEPK13__nv_bfloat16
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


def _sass_body() -> str:
    """A loop body from 0x30: HGMMA, 32 MUFU.EX2, a block a forward branch
    skips (a rescale: 32 FMULs), an inner loop inside that block."""
    lines, addr = [], 0x30

    def add(text):
        nonlocal addr
        lines.append(f"        /*{addr:04x}*/                   {text} ;")
        addr += 0x10

    add("HGMMA.64x64x16.F32.BF16 R56, gdesc[UR8], R56, gsb0")
    for _ in range(32):
        add("MUFU.EX2 R7, R7")
    start = addr
    skip_to = start + 0x10 * 36
    add(f"@P1 BRA {hex(skip_to)}")
    for _ in range(32):
        add("FMUL R8, R8, R9")
    add(f"@P2 BRA {hex(start + 0x10)}")  # an inner backward branch inside the skipped block
    add("NOP")
    add("NOP")
    assert addr == skip_to
    add("@P0 F2FP.BF16.F32.PACK_AB R10, R11, R12")
    while addr < 0xf00:
        add("NOP")
    return "\n".join(lines)


def test_probe_sass_counts_the_common_path(monkeypatch, tmp_path):
    """``chip_smoke.probe_sass`` names the probes' kernels, counts
    their wgmma and mma.sync opcodes, and per loop the opcodes its body
    always runs: a block that a forward branch skips (a rescale) and the
    loop inside it are left out; MUFU.EX2 / 32 gives the tiles an
    iteration."""
    import subprocess

    import chip_smoke
    from stutter_tpu_torch.ops import _build

    text = _SASS.replace("{body}", _sass_body())
    monkeypatch.setattr(_build, "_nvcc", lambda: "/toolkit/bin/nvcc")
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=text, stderr="")

    monkeypatch.setattr(subprocess, "run", run)
    rows = chip_smoke.probe_sass(tmp_path / "lib.so")
    assert calls[0][:2] == ["/toolkit/bin/cuobjdump", "-sass"]
    assert [row["kernel"] for row in rows] == ["attn_int8", "softmax_variant<1, 0>"]
    int8, variant = rows
    assert (int8["IGMMA"], int8["HGMMA"], int8["passes"]) == (1, 0, [])
    assert (variant["HGMMA"], variant["HMMA"], variant["IMMA"]) == (2, 0, 0)
    (loop,) = variant["passes"]
    assert loop["tiles_an_iteration"] == 1
    per = loop["per_score"]
    assert per["MUFU.EX2"] == 1.0 and per["FFMA"] == round(1 / 32, 3) and "FMUL" not in per
    assert per["F2FP"] == round(1 / 32, 3)  # a predicated instruction counts as its opcode
