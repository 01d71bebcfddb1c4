"""The plain references against the program's CPU path at tiny sizes, in
float32 (the fidelity preset), and the references' independence from the
program and from JAX."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import load_module
from benchmark.reference import wavlm as ref_wavlm
from benchmark.reference import whisper as ref_whisper
from benchmark.tests.conftest import REPO, TINY


def clips(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [(0.3 * np.sin(np.arange(n) / 16000 * 2 * np.pi * rng.uniform(100, 600))
             + 0.05 * rng.standard_normal(n)).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("family,samples", [("wavlm", 8000), ("whisper", 480_000)])
def test_reference_matches_the_programs_float32_path(family, samples):
    from stutter_tpu_torch.extract.batcher import Batch

    fam = load_module(REPO / "benchmark" / "families" / f"{family}.py")
    config = TINY[f"tiny-{family}"]
    model, weights = fam.build(config, 7, torch.device("cpu"))
    extractor = fam.extractor(model, "cpu", "fidelity")
    waves = clips((6000, 7000, 4100))
    batch = np.zeros((len(waves), samples), np.float32)
    for i, w in enumerate(waves):
        batch[i, : len(w)] = w
    got = extractor(Batch(paths=["a", "b", "c"], rows=[0, 1, 2], waves=batch,
                          lengths=np.array([len(w) for w in waves]), ok=np.ones(3, bool),
                          bucket_s=samples / 16000))
    want = fam.reference_rows(config, weights, waves, "cpu")
    assert set(got) == set(want[0]) == set(fam.columns(config))
    for j, row in enumerate(want):
        for col, r in row.items():
            a = got[col][j].astype(np.float64)
            assert 1 - a @ r / np.linalg.norm(a) / np.linalg.norm(r) < 1e-10
            assert np.abs(a - r).max() < 1e-4 * max(1.0, np.abs(r).max())


def test_relative_position_buckets_match_the_programs():
    from stutter_tpu_torch.models.wavlm import relative_position_buckets

    for L in (1, 37, 160, 1504):
        assert np.array_equal(ref_wavlm.buckets(L, 320, 800),
                              relative_position_buckets(L, 320, 800))


def test_log_mel_matches_the_programs_plain_frontend():
    from stutter_tpu_torch.frontend.whisper_frontend import whisper_features
    from stutter_tpu_torch.ops.mel import mel_filter_bank

    for n_mels in (80, 128):
        np.testing.assert_allclose(ref_whisper.mel_bank(n_mels), mel_filter_bank(
            201, n_mels, 0.0, 8000.0, 16000).astype(np.float64), rtol=1e-6, atol=1e-9)
    waves = torch.from_numpy(np.stack([np.pad(w, (0, 48000 - len(w)))
                                       for w in clips((48000, 30000))]))
    got = whisper_features(waves)
    want = ref_whisper.log_mel(waves, 80)
    assert got.shape == want.shape == (2, 80, 3000)
    assert float((got - want).abs().max()) < 1e-4


def test_reference_adamw_resumes_from_a_state():
    """Two steps of one optimizer equal one step, then a second optimizer
    that starts from the first's count and moments: how the reference
    follows an update of the window from the program's state."""
    from benchmark.reference.finetune import AdamW

    g = torch.Generator().manual_seed(3)
    W0 = {"a": torch.randn(5, 4, generator=g), "b": torch.randn(3, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in W0.items()} for _ in range(2)]
    lrs = {"a": 1e-2, "b": 1e-3}
    whole = {k: v.clone() for k, v in W0.items()}
    opt = AdamW(lrs, 1e-4)
    for gr in grads:
        opt.step(whole, gr)
    split = {k: v.clone() for k, v in W0.items()}
    first = AdamW(lrs, 1e-4)
    first.step(split, grads[0])
    AdamW(lrs, 1e-4, t=first.t, mu=first.mu, nu=first.nu).step(split, grads[1])
    for k in W0:
        assert torch.equal(whole[k], split[k])


def test_references_import_nothing_of_the_program_or_jax():
    code = ("import sys, json; sys.path.insert(0, %r);"
            "import benchmark.reference.wavlm, benchmark.reference.whisper;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"stutter_tpu_torch", "stutter_tpu", "jax", "jaxlib", "flax"}
