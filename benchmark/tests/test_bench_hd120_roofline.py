"""The wav2vec2 family and the head_dim 120 flash kernel's roofline reader
on the CPU: the frozen count equals the program's own (``chip_smoke.py``'s
[flash_mha_hd120] and the FLOP model), the reader reads a percent only where
the trace's 120-wide launches match the traced batches, the plain reference
matches the program's float32 path and imports nothing of it, and a tiny
wav2vec2 cell runs through the harness."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import yardstick, yardstick_heads
from benchmark.harness import Run, load_module, run_cell
from benchmark.tests.conftest import REPO, tiny_cell, write_root

CONFIG = json.loads((REPO / "benchmark" / "configs" / "wav2vec2-xls-r-2b.json").read_text())
READER = load_module(REPO / "benchmark" / "metrics" / "flash_mha_hd120_roofline.py")
FAMILY = load_module(REPO / "benchmark" / "families" / "wav2vec2.py")
BATCHES = [(12, 322_640), (8, 481_360), (8, 481_360)]  # the 20 s and 30 s buckets
NAME_120 = ("void sm90::attention_bf16_kernel<(anonymous namespace)::KeyPadding, 120, 2, 4, 1, "
            "0>(__nv_bfloat16 const*, __nv_bfloat16 const*)")
NAME_64 = ("void sm90::attention_bf16_kernel<(anonymous namespace)::KeyPadding, 64, 2, 4, 2, "
           "0>(__nv_bfloat16 const*, __nv_bfloat16 const*)")
TINY_W2V = {
    "family": "wav2vec2", "source": "https://huggingface.co/facebook/wav2vec2-xls-r-2b",
    "preset": "fidelity", "control_preset": "turbo", "hidden_size": 32,
    "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
    "conv_dim": [16, 16, 16], "conv_stride": [5, 2, 2], "conv_kernel": [10, 3, 3],
    "conv_bias": True, "feat_extract_norm": "layer", "do_stable_layer_norm": True,
    "num_conv_pos_embeddings": 16, "num_conv_pos_embedding_groups": 16,
    "layer_norm_eps": 1e-5, "do_normalize": True, "reduced": [],
    "check": {"clips": 6, "limits": {"missing_rows": 0, "pooled_cos_dist": 1e-6}},
}


class FakeTrace:
    """``kernel_time`` over named launches of given seconds each."""

    def __init__(self, launches: dict[str, tuple[int, float]]):
        self.launches = launches

    def kernel_time(self, pattern):
        hits = [(n, s) for name, (n, s) in self.launches.items() if pattern in name]
        return sum(n * s for n, s in hits), sum(n for n, _ in hits)


def _run(trace, launches, batches=BATCHES):
    return Run(SimpleNamespace(config=CONFIG),
               {"trace": trace, "trace_batches": batches,
                "trace_launches": {"flash_mha": launches, "gated_attn_fwd": 0}})


@pytest.mark.parametrize("B,L,bound_ms", [(8, 1504, 0.1405), (12, 1008, 0.0947),
                                          (3, 1504, 0.0527)])
def test_count_matches_chip_smoke(B, L, bound_ms):
    """chip_smoke.py:mha_cases prices a call without its key counts; the
    model passes them, so the reader's count reads their 4 B bytes too."""
    n = B * 16 * L * 120  # at the true width
    assert yardstick_heads.flash_mha_fwd(B, 16, L, 120, key_counts=False) == (
        4 * n * L, 4 * n * 2)
    flops, nbytes = yardstick_heads.flash_mha_fwd(B, 16, L, 120)
    assert (flops, nbytes) == (4 * n * L, 4 * n * 2 + 4 * B)
    assert 1e3 * yardstick.bound_s(flops, nbytes) == pytest.approx(bound_ms, abs=1e-4)
    # never the 128 the kernel pads q k^T to
    assert flops < yardstick_heads.flash_mha_fwd(B, 16, L, 128)[0]


def test_width_64_without_key_counts_is_the_frozen_flash_count():
    assert yardstick_heads.flash_mha_fwd(16, 20, 1500, 64, key_counts=False) == \
        yardstick.flash_mha_fwd(16, 20, 1500)


@pytest.mark.parametrize("n_samples", [322_640, 481_360, 400_000])
def test_flops_match_the_programs(n_samples):
    """``clip_flops`` is the program's FLOP model of this encoder, and the
    reader's attention calls are its score and value products."""
    from stutter_tpu_torch.utils.benchmarking import wavlm_flops

    enc, stem, L = wavlm_flops(FAMILY.model_config(CONFIG), 1, n_samples)
    assert FAMILY.clip_flops(CONFIG, n_samples) == enc + stem
    D, F, N = CONFIG["hidden_size"], CONFIG["intermediate_size"], CONFIG["num_hidden_layers"]
    attention = sum(ops for ops, _ in READER.calls(CONFIG, 1, n_samples))
    assert attention == enc - 2 * (4 * D * D + 2 * D * F) * L * N


def test_reads_the_bound_over_the_120_wide_kernels_time():
    calls = [c for B, n in BATCHES for c in READER.calls(CONFIG, B, n)]
    assert len(calls) == 3 * 48
    trace = FakeTrace({NAME_120: (len(calls), 0.5e-3), "GatedBiasRing": (10, 1.0),
                       "stem_conv_kernel<3>": (18, 1e-3)})
    least = sum(yardstick.bound_s(ops, nbytes) for ops, nbytes in calls)
    got = READER.read(_run(trace, len(calls)))
    assert got == pytest.approx(100.0 * least / (len(calls) * 0.5e-3), rel=1e-12)
    assert 0 < got < 100


@pytest.mark.parametrize("launches,wrapper", [
    ({}, 0),                                   # the parent: no 120-wide kernel
    ({NAME_64: (144, 1e-4)}, 144),              # the 64-wide kernel alone
    ({NAME_120: (144, 1e-4), NAME_64: (1, 1e-4)}, 145),  # a 64-wide launch beside them
    ({NAME_120: (143, 1e-4)}, 144)])            # launches and batches disagree
def test_silent_where_launches_and_batches_disagree(launches, wrapper):
    assert READER.read(_run(FakeTrace(launches), wrapper)) is None


def test_silent_without_a_trace():
    assert READER.read(_run(None, 144)) is None
    assert READER.read(Run(SimpleNamespace(config=CONFIG), {})) is None


def test_reference_matches_the_programs_float32_path():
    from stutter_tpu_torch.extract.batcher import Batch

    model, weights = FAMILY.build(TINY_W2V, 7, torch.device("cpu"))
    extractor = FAMILY.extractor(model, "cpu", "fidelity")
    rng = np.random.default_rng(0)
    waves = [(0.3 * np.sin(np.arange(n) / 16000 * 2 * np.pi * rng.uniform(100, 600))
              + 0.05 * rng.standard_normal(n)).astype(np.float32) for n in (6000, 7000, 4100)]
    batch = np.zeros((3, 8000), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    got = extractor(Batch(paths=["a", "b", "c"], rows=[0, 1, 2], waves=batch,
                          lengths=np.array([len(w) for w in waves]), ok=np.ones(3, bool),
                          bucket_s=0.5))
    want = FAMILY.reference_rows(TINY_W2V, weights, waves, "cpu")
    assert set(got) == set(want[0]) == set(FAMILY.columns(TINY_W2V))
    for j, row in enumerate(want):
        for col, r in row.items():
            a = got[col][j].astype(np.float64)
            assert 1 - a @ r / np.linalg.norm(a) / np.linalg.norm(r) < 1e-10
            assert np.abs(a - r).max() < 1e-4 * max(1.0, np.abs(r).max())


def test_columns_are_wavlms_default_layers():
    assert FAMILY.columns(CONFIG) == {"layer_48": 48, "layer_47": 47, "layer_46": 46,
                                      "layer_24": 24}
    assert CONFIG["reduced"] == [] and CONFIG["num_hidden_layers"] == 48
    assert CONFIG["hidden_size"] // CONFIG["num_attention_heads"] == 120


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, json; sys.path.insert(0, %r);"
            "import benchmark.reference.wav2vec2, benchmark.families.wav2vec2;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"stutter_tpu_torch", "stutter_tpu", "jax", "jaxlib", "flax"}


def test_tiny_cell_runs_through_the_harness(tmp_path):
    root = write_root(tmp_path, [tiny_cell("tiny-w2v.mix", "tiny-w2v")])
    (root / "benchmark" / "configs" / "tiny-w2v.json").write_text(json.dumps(TINY_W2V))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-w2v", "source": TINY_W2V["source"],
                             "file": "benchmark/configs/tiny-w2v.json", "reduced": [],
                             "why": "a tiny configuration for the CPU tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (False, True):
        result = run_cell(root, "tiny-w2v.mix", 2**31 + 5, 0.5, trace, time.perf_counter(),
                          device="cpu", bench_dir=root / "benchmark")[0]
        assert result["correct"], result["checks"]
        assert result["attempted"] >= 6 and result["failed"] == 0
        assert set(result["checks"]) == {"missing_rows", "pooled_cos_dist"}
