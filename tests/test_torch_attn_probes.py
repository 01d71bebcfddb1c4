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
