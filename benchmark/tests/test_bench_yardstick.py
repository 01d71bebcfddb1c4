"""The frozen yardsticks against the program's own counts at today's shapes:
``stutter_tpu_torch/utils/benchmarking.py`` (FLOP models, peaks, ``bound``)
and the operation and byte counts that ``chip_smoke.py`` prices its kernels
by (``phase_kernel``, ``phase_mha``, ``phase_attn_bwd``), restated here."""

from __future__ import annotations

import json

import pytest

from benchmark import yardstick
from benchmark.tests.conftest import REPO


def config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def test_peaks_and_bound_match_the_programs():
    from stutter_tpu_torch.utils import benchmarking as ours

    assert (yardstick.BF16_PEAK, yardstick.F32_PEAK, yardstick.HBM_BYTES_PER_S) == (
        ours.BF16_PEAK, ours.F32_PEAK, ours.HBM_BYTES_PER_S)
    for flops, nbytes in ((1e12, 1e6), (1e6, 1e12), (4e11, 2e9)):
        ms, _ = ours.bound(flops, nbytes, ours.BF16_PEAK)
        assert yardstick.bound_s(flops, nbytes) == pytest.approx(ms / 1e3, rel=1e-12)


@pytest.mark.parametrize("n_samples", [51_280, 48_000, 32_000, 481_360, 400])
def test_wavlm_flops_match_the_programs(n_samples):
    from benchmark.families.wavlm import model_config
    from stutter_tpu_torch.utils.benchmarking import wavlm_flops

    cfg = config("wavlm-large")
    enc, stem, _ = wavlm_flops(model_config(cfg), 1, n_samples)
    assert yardstick.wavlm_flops(cfg, n_samples) == enc + stem


def test_whisper_flops_match_the_programs():
    from benchmark.families.whisper import model_config
    from stutter_tpu_torch.utils.benchmarking import whisper_encoder_flops

    cfg = config("whisper-large")
    assert yardstick.whisper_encoder_flops(cfg) == whisper_encoder_flops(model_config(cfg), 1)
    assert 16 * yardstick.whisper_encoder_flops(cfg) == pytest.approx(36.363e12, rel=1e-3)


@pytest.mark.parametrize("B,H,L", [(80, 16, 160), (128, 16, 160), (12, 16, 1504)])
def test_gated_attention_counts_match_chip_smoke(B, H, L):
    n = B * H * L * 64  # chip_smoke.py:phase_kernel
    assert yardstick.gated_attention_fwd(B, H, L) == (
        4 * n * L, 4 * n * 2 + 4 * (H * L * L + B * H * L + B * L))
    # chip_smoke.py:phase_attn_bwd
    assert yardstick.gated_attention_bwd(B, H, L) == (
        10 * n * L, 8 * n * 2 + 4 * (2 * H * L * L + 4 * B * H * L + B * L))


def test_flash_mha_counts_match_chip_smoke():
    B, H, L = 16, 20, 1500
    n = B * H * L * 64  # chip_smoke.py:phase_mha
    assert yardstick.flash_mha_fwd(B, H, L) == (4 * n * L, 4 * n * 2)
    # PERF.md's kernel table, row 7: 0.1864 ms, bound by operations
    assert yardstick.bound_s(*yardstick.flash_mha_fwd(B, H, L)) * 1e3 == pytest.approx(
        0.1864, abs=1e-4)


def test_frame_counts_match_the_programs():
    from benchmark.families.wavlm import model_config
    from stutter_tpu_torch.models.wavlm import wavlm_feature_lengths

    cfg = config("wavlm-large")
    for n in (400, 48_000, 51_280, 481_360):
        assert yardstick.conv_lengths(n, cfg["conv_kernel"], cfg["conv_stride"])[-1] == \
            wavlm_feature_lengths(model_config(cfg), n)
