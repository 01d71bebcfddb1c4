"""The w2v_bert family and the relative-key attention's roofline reader on
the CPU: the frozen counts equal the program's own (its frontend's rows, the
kernel's work as ``chip_smoke.py``'s [relkey_attn] prices it), the reader
reads a percent only where the trace's launches, the traced batches and the
program's count agree, the plain reference matches the program's float32
path and imports nothing of it, and a tiny w2v-BERT cell runs through the
harness."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import program_spans, yardstick, yardstick_conformer
from benchmark.harness import Run, load_module, run_cell
from benchmark.tests.conftest import REPO, tiny_cell, write_root

CONFIG = json.loads((REPO / "benchmark" / "configs" / "w2v-bert-2.0.json").read_text())
READER = load_module(REPO / "benchmark" / "metrics" / "relkey_attn_roofline.py")
FAMILY = load_module(REPO / "benchmark" / "families" / "w2v_bert.py")
BATCHES = [(12, 320_000), (8, 480_000), (8, 480_000)]  # the 20 s and 30 s buckets
NAME = ("void sm90::attention_bf16_kernel<(anonymous namespace)::RelKeyTable<__nv_bfloat16>, "
        "64, 2, 4, 2, 0>(__nv_bfloat16 const*, __nv_bfloat16 const*)")
NAME_MHA = ("void sm90::attention_bf16_kernel<(anonymous namespace)::KeyPadding, 64, 2, 4, 2, "
            "0>(__nv_bfloat16 const*, __nv_bfloat16 const*)")
TINY_W2V_BERT = {
    "family": "w2v_bert", "source": "https://huggingface.co/facebook/w2v-bert-2.0",
    "preset": "fidelity", "control_preset": "turbo", "hidden_size": 32,
    "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 64,
    "feature_projection_input_dim": 160, "hidden_act": "swish",
    "position_embeddings_type": "relative_key", "left_max_position_embeddings": 64,
    "right_max_position_embeddings": 8, "conv_depthwise_kernel_size": 31,
    "layer_norm_eps": 1e-5, "num_mel_bins": 80, "stride": 2, "sampling_rate": 16000,
    "reduced": [],
    "check": {"clips": 6, "limits": {"missing_rows": 0, "pooled_cos_dist": 1e-6}},
}


class FakeTrace:
    """``kernel_time`` over named launches of given seconds each."""

    def __init__(self, launches: dict[str, tuple[int, float]]):
        self.launches = launches

    def kernel_time(self, pattern):
        hits = [(n, s) for name, (n, s) in self.launches.items() if pattern in name]
        return sum(n * s for n, s in hits), sum(n for n, _ in hits)


class FakeRecorder:
    """The program's recorder holding one profiled ``w2v_bert.layers`` span
    a batch, each counting ``per_batch`` launches."""

    def __init__(self, per_batch: list[int], profiled: bool = True):
        self.spans = [SimpleNamespace(name="w2v_bert.layers", profiled=profiled,
                                      attrs={"relkey_attn_launches": n}) for n in per_batch]

    def records(self):
        return self.spans


def _run(trace, batches=BATCHES):
    return Run(SimpleNamespace(config=CONFIG), {"trace": trace, "trace_batches": batches})


@pytest.mark.parametrize("n_samples,rows", [(320_000, 999), (480_000, 1499), (400, 0),
                                            (560, 1), (399, 0), (17_153, 52)])
def test_rows_match_the_programs_frontend(n_samples, rows):
    from stutter_tpu_torch.frontend.w2v_bert_frontend import w2v_bert_frame_lengths

    assert yardstick_conformer.rows(n_samples) == rows == w2v_bert_frame_lengths(n_samples)


@pytest.mark.parametrize("B,L,bound_ms", [(8, 1499, 0.0763), (12, 999, 0.0514),
                                          (8, 1504, 0.0768), (12, 1008, 0.0523)])
def test_count_matches_chip_smoke(B, L, bound_ms):
    """``chip_smoke.py:phase_relkey_attn`` prices a call as the reader does:
    4 B H L^2 64 + 2 B H L 73 64 operations; q, k, v and out in bf16, E and
    the key counts once."""
    n = B * 16 * L * 64
    flops, nbytes = yardstick_conformer.relkey_attn_fwd(B, 16, L)
    assert (flops, nbytes) == (4 * n * L + 2 * n * 73, 4 * n * 2 + 73 * 64 * 2 + 4 * B)
    assert 1e3 * yardstick.bound_s(flops, nbytes) == pytest.approx(bound_ms, abs=1e-4)


@pytest.mark.parametrize("n_samples", [320_000, 480_000, 250_000])
def test_flops_are_the_conformer_count(n_samples):
    """``clip_flops``: the projection, then per row per layer the FFNs, q, k,
    v, o, the scores and values (the reader's attention calls without T),
    T, and the conv module: 1.26-1.31 GFLOP a row at the 20 s and 30 s buckets."""
    L = yardstick_conformer.rows(n_samples)
    D, F, N = CONFIG["hidden_size"], CONFIG["intermediate_size"], CONFIG["num_hidden_layers"]
    attention = sum(ops for ops, _ in READER.calls(CONFIG, 1, n_samples))
    dense = 2 * L * N * (4 * D * F + 4 * D * D + 3 * D * D + 31 * D) + 2 * L * 160 * D
    assert FAMILY.clip_flops(CONFIG, n_samples) == pytest.approx(dense + attention, rel=1e-12)
    if n_samples >= 320_000:
        assert 1.25e9 < FAMILY.clip_flops(CONFIG, n_samples) / L < 1.32e9


def test_reads_the_bound_over_the_kernels_time(monkeypatch):
    calls = [c for B, n in BATCHES for c in READER.calls(CONFIG, B, n)]
    assert len(calls) == 3 * 24
    monkeypatch.setattr(program_spans, "RECORDER", FakeRecorder([24, 24, 24]))
    trace = FakeTrace({NAME: (len(calls), 0.5e-3), NAME_MHA: (10, 1.0)})
    least = sum(yardstick.bound_s(ops, nbytes) for ops, nbytes in calls)
    got = READER.read(_run(trace))
    assert got == pytest.approx(100.0 * least / (len(calls) * 0.5e-3), rel=1e-12)
    assert 0 < got < 100


@pytest.mark.parametrize("launches,recorder", [
    ({}, [24, 24, 24]),                        # the parent: no such kernel
    ({NAME_MHA: (72, 1e-4)}, [24, 24, 24]),    # another policy's kernel alone
    ({NAME: (71, 1e-4)}, [24, 24, 24]),        # launches and batches disagree
    ({NAME: (72, 1e-4)}, [24, 24, 23]),        # the program counted otherwise
    ({NAME: (72, 1e-4)}, []),                  # the program counted nothing
])
def test_silent_where_counts_disagree(monkeypatch, launches, recorder):
    monkeypatch.setattr(program_spans, "RECORDER", FakeRecorder(recorder))
    assert READER.read(_run(FakeTrace(launches))) is None


def test_silent_without_a_trace_or_a_recorder(monkeypatch):
    monkeypatch.setattr(program_spans, "RECORDER", None)
    assert READER.read(_run(FakeTrace({NAME: (72, 1e-4)}))) is None
    assert READER.read(_run(None)) is None
    assert READER.read(Run(SimpleNamespace(config=CONFIG), {})) is None


def test_reference_matches_the_programs_float32_path():
    from stutter_tpu_torch.extract.batcher import Batch

    model, weights = FAMILY.build(TINY_W2V_BERT, 7, torch.device("cpu"))
    extractor = FAMILY.extractor(model, "cpu", "fidelity")
    rng = np.random.default_rng(0)
    waves = [(0.3 * np.sin(np.arange(n) / 16000 * 2 * np.pi * rng.uniform(100, 600))
              + 0.05 * rng.standard_normal(n)).astype(np.float32) for n in (9000, 12000, 7300)]
    batch = np.zeros((3, 12000), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    got = extractor(Batch(paths=["a", "b", "c"], rows=[0, 1, 2], waves=batch,
                          lengths=np.array([len(w) for w in waves]), ok=np.ones(3, bool),
                          bucket_s=0.75))
    want = FAMILY.reference_rows(TINY_W2V_BERT, weights, waves, "cpu")
    assert set(got) == set(want[0]) == set(FAMILY.columns(TINY_W2V_BERT))
    for j, row in enumerate(want):
        for col, r in row.items():
            a = got[col][j].astype(np.float64)
            assert 1 - a @ r / np.linalg.norm(a) / np.linalg.norm(r) < 1e-6
            assert np.abs(a - r).max() < 1e-3 * max(1.0, np.abs(r).max())


def test_config_is_the_published_model_uncut():
    assert FAMILY.columns(CONFIG) == {"layer_24": 24, "layer_23": 23, "layer_22": 22,
                                      "layer_12": 12}
    assert CONFIG["reduced"] == [] and CONFIG["num_hidden_layers"] == 24
    cfg = FAMILY.model_config(CONFIG)
    assert (cfg.hidden_size, cfg.head_dim, cfg.intermediate_size) == (1024, 64, 4096)


def test_build_draws_the_distance_embeddings_at_k_scale():
    """The [73, d] distance embeddings at std ~1 (the draw's 1/sqrt(d) times
    sqrt(d), exact in bf16), every other weight as ``seeded_weights`` draws
    it, and the model holding what the reference reads."""
    from benchmark.weights import seeded_weights

    model, weights = FAMILY.build(TINY_W2V_BERT, 2**31 + 3, torch.device("cpu"))
    plain = seeded_weights(type(model)(model.cfg), 2**31 + 3)
    emb = [k for k in weights if k.endswith("attention.distance_embedding")]
    assert len(emb) == 2 and set(weights) == set(plain)
    for k, w in weights.items():
        assert torch.equal(w, plain[k] * (8 ** 0.5 if k in emb else 1)), k
    assert 0.8 < float(weights[emb[0]].float().std()) < 1.2
    saved = model.state_dict()
    assert all(torch.equal(saved[k].to(torch.bfloat16), w) for k, w in weights.items())


def test_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, json; sys.path.insert(0, %r);"
            "import benchmark.reference.w2v_bert, benchmark.families.w2v_bert;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"stutter_tpu_torch", "stutter_tpu", "jax", "jaxlib", "flax",
                         "transformers"}


def test_tiny_cell_runs_through_the_harness(tmp_path):
    root = write_root(tmp_path, [tiny_cell("tiny-w2v-bert.mix", "tiny-w2v-bert")])
    (root / "benchmark" / "configs" / "tiny-w2v-bert.json").write_text(
        json.dumps(TINY_W2V_BERT))
    mix = json.loads((root / "benchmark" / "traffic" / "tiny-mix.json").read_text())
    mix["seconds"] = [0.5, 0.8]  # the fbank takes 400 samples a frame
    (root / "benchmark" / "traffic" / "tiny-mix.json").write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-w2v-bert", "source": TINY_W2V_BERT["source"],
                             "file": "benchmark/configs/tiny-w2v-bert.json", "reduced": [],
                             "why": "a tiny configuration for the CPU tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for trace in (False, True):
        result = run_cell(root, "tiny-w2v-bert.mix", 2**31 + 9, 0.5, trace,
                          time.perf_counter(), device="cpu", bench_dir=root / "benchmark")[0]
        assert result["correct"], result["checks"]
        assert result["attempted"] >= 6 and result["failed"] == 0
        assert set(result["checks"]) == {"missing_rows", "pooled_cos_dist"}
