"""The layer norm's kernel wrapper on the CPU.

The CUDA kernel (``csrc/layer_norm.cu``) runs only on the card, where
``chip_smoke.py`` [layer_norm] holds it against the plain version. Here: the
plain version, alone and with the residual add, equals the formula the models
computed before the kernel, bit for bit, in f32 and bf16; the gate (bf16 on
the card, the last axis, contiguous and aligned, a width the kernel is built
for, bf16 parameters, no autograd) deciding with no flag where the models
take the kernel; the launch counts of a forward (2 a pre-LN layer, 1 the
final norm, 1 the projection's, and Whisper's decoder's 3 a layer and 1)
and of a fine-tuning step (0); and the models' CPU forwards unchanged.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
from stutter_tpu_torch.models import common
from stutter_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from stutter_tpu_torch.models.wavlm import WavLMConfig
from stutter_tpu_torch.models.whisper import WhisperConfig
from stutter_tpu_torch.ops import layer_norm as ln
from stutter_tpu_torch.train.finetune import FinetuneConfig, FinetuneTrainer
from stutter_tpu_torch.weights.convert import init_wav2vec2, init_wavlm, init_whisper

torch.set_num_threads(2)  # six xdist workers share the host

EPS = 1e-5


def _formula(x, scale, bias, eps, dim=-1):
    """The models' norm as it stood before the kernel (``common.layer_norm``)."""
    xf = x.float()
    mean = xf.mean(dim=dim, keepdim=True)
    var = (xf - mean).square().mean(dim=dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = -1
    return ((xf - mean) * torch.rsqrt(var + eps) * scale.view(shape)
            + bias.view(shape)).to(x.dtype)


def _rows(rows: int, D: int, dtype, seed: int = 0) -> torch.Tensor:
    """[rows, D] of mixed magnitudes; from three rows on, one constant row
    (variance 0) and zeroed padding rows at the end."""
    r = np.random.RandomState(seed + rows + D)
    x = r.randn(rows, D) * r.choice([0.05, 1.0, 30.0], size=(rows, 1)) + r.randn(rows, 1)
    if rows >= 3:
        x[rows // 2] = 2.5
        x[-2:] = 0.0
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


def _params(D: int, dtype, seed: int = 1):
    g = torch.Generator().manual_seed(seed + D)
    return ((1.0 + 0.1 * torch.randn(D, generator=g)).to(dtype),
            (0.02 * torch.randn(D, generator=g)).to(dtype))


DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [32, 512, 1024, 1280, 1920]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("rows", [1, 7, 33])
def test_plain_version_is_the_models_norm_bit_for_bit(dtype, D, rows):
    x = _rows(rows, D, dtype)
    scale, bias = _params(D, dtype)
    want = _formula(x, scale, bias, EPS)
    got = ln.layer_norm_reference(x, scale, bias, EPS)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(common.layer_norm(x, scale, bias, EPS), want)
    s, out = ln.add_layer_norm(x, None, scale, bias, EPS)  # on the CPU: the plain version
    assert s is x and torch.equal(out, want)
    # [B, L, D] and the stem's [B, C, T] norm over dim 1
    x3 = x.view(1, rows, D)
    assert torch.equal(common.layer_norm(x3, scale, bias, EPS), want.view(1, rows, D))
    xt = x3.transpose(1, 2).contiguous()
    assert torch.equal(common.layer_norm(xt, scale, bias, EPS, dim=1),
                       _formula(xt, scale, bias, EPS, dim=1))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", WIDTHS)
def test_fused_plain_version_is_the_add_then_the_norm(dtype, D):
    """(x + delta, LN(x + delta)): the sum rounded to x's dtype, as the
    layers' ``x = x + attention(...)`` rounds it, then the norm of that sum."""
    x, delta = _rows(9, D, dtype, seed=2), _rows(9, D, dtype, seed=3)
    scale, bias = _params(D, dtype)
    s_want = x + delta
    want = _formula(s_want, scale, bias, EPS)
    for s, out in (ln.add_layer_norm_reference(x, delta, scale, bias, EPS),
                   common.add_layer_norm(x, delta, scale, bias, EPS)):
        assert s.dtype == out.dtype == dtype
        assert torch.equal(s, s_want) and torch.equal(out, want)


@pytest.fixture
def fake_card(monkeypatch):
    """Treats the CPU as the card in the gate and the wrapper, with the
    plain version for the kernel's launch; the counts start at 0 and are
    restored after."""
    monkeypatch.setattr(ln, "_on_card", lambda t: t.device.type in ("cpu", "cuda"))
    monkeypatch.setattr(ln, "_launch", lambda x, delta, scale, bias, eps:
                        ln.add_layer_norm_reference(x, delta, scale, bias, eps))
    monkeypatch.setattr(ln.add_layer_norm, "launches", 0)
    monkeypatch.setattr(ln.add_layer_norm, "launches_fused", 0)


def _gate_case(case: str):
    """(x, scale, bias, dim, delta) of one case of the gate, at D = 1024."""
    D = 1024
    x = _rows(6, D, torch.bfloat16).view(2, 3, D)
    scale, bias = _params(D, torch.bfloat16)
    delta, dim = None, -1
    if case == "fused":
        delta = _rows(6, D, torch.bfloat16, seed=4).view(2, 3, D)
    elif case == "f32":
        x = x.float()
    elif case == "f32_params":
        scale, bias = scale.float(), bias.float()
    elif case == "mixed_params":
        scale = scale.float()
    elif case == "misaligned_params":  # a view one element into its storage
        scale = torch.cat([scale[:1], scale])[1:]
    elif case == "dim1":  # the stem's norm over the channels of [B, C, T]
        x, dim = x.transpose(1, 2).contiguous(), 1
    elif case == "last_dim_positive":
        dim = 2
    elif case == "width":
        x = x[..., :768].contiguous()
        scale, bias = _params(768, torch.bfloat16)
    elif case == "non_contiguous":
        x = _rows(6, 2 * D, torch.bfloat16).view(2, 3, 2 * D)[..., ::2]
    elif case == "transposed":
        x = x.transpose(0, 1)
    elif case == "misaligned":
        flat = _rows(1, 6 * D + 1, torch.bfloat16).flatten()
        x = flat[1:].view(2, 3, D)
    elif case == "no_rows":
        x = x[:0]
    elif case == "delta_shape":
        delta = _rows(3, D, torch.bfloat16).view(1, 3, D)
    elif case == "delta_f32":
        delta = _rows(6, D, torch.float32).view(2, 3, D)
    elif case == "delta_non_contiguous":
        delta = _rows(6, 2 * D, torch.bfloat16).view(2, 3, 2 * D)[..., ::2]
    elif case in ("grad_param", "grad_off", "grad_x", "inference"):
        if case == "grad_x":
            x.requires_grad_(True)
        else:
            scale = scale.clone().requires_grad_(True)
    elif case != "base":
        raise ValueError(case)
    return x, scale, bias, dim, delta


# case, whether the gate passes, launches of the call through ``common``
GATE_CASES = [("base", True, 1), ("fused", True, 1),
              ("last_dim_positive", True, 1), ("grad_off", True, 1), ("inference", True, 1),
              ("f32", False, 0), ("f32_params", False, 0), ("mixed_params", False, 0),
              ("misaligned_params", False, 0), ("dim1", False, 0),
              ("width", False, 0), ("non_contiguous", False, 0), ("transposed", False, 0),
              ("misaligned", False, 0), ("no_rows", False, 0), ("delta_shape", False, 0),
              ("delta_f32", False, 0), ("delta_non_contiguous", False, 0),
              ("grad_param", False, 0), ("grad_x", False, 0)]


@pytest.mark.parametrize("case,taken,launches", GATE_CASES)
def test_gate(fake_card, case, taken, launches):
    """bf16 x (and delta) of one shape, the last axis, contiguous and
    aligned, a kernel width, a row or more, bf16 scale and bias, contiguous
    and aligned, and nothing for autograd to record: the kernel; everything
    else the plain path, with the same result. ``common.layer_norm`` decides
    the axis, ``kernel_applies`` the rest."""
    x, scale, bias, dim, delta = _gate_case(case)
    context = {"grad_off": torch.no_grad, "inference": torch.inference_mode}.get(
        case, torch.enable_grad)
    with context():
        assert (ln.kernel_applies(x, scale, bias, delta) and dim in (-1, x.dim() - 1)) == taken
        if delta is None:
            out = common.layer_norm(x, scale, bias, EPS, dim)
            want = _formula(x, scale, bias, EPS, dim)
        else:
            s, out = common.add_layer_norm(x, delta, scale, bias, EPS)
            want = _formula(x + delta, scale, bias, EPS)
            assert torch.equal(s, x + delta)
    assert torch.equal(out, want)
    assert ln.add_layer_norm.launches == launches
    assert ln.add_layer_norm.launches_fused == int(taken and delta is not None)
    assert out.requires_grad == (case in ("grad_param", "grad_x"))


def test_cpu_tensors_stay_plain():
    """Without the fake card a CPU tensor is never the kernel's."""
    x, scale, bias, dim, delta = _gate_case("fused")
    assert not ln.kernel_applies(x, scale, bias)
    assert not ln.kernel_applies(x, scale, bias, delta)


@pytest.mark.parametrize("case", ["f32", "f32_params", "misaligned_params", "grad_param"])
def test_wrapper_runs_the_plain_version_where_the_gate_refuses(fake_card, case):
    """The wrapper owns the gate: what it refuses runs plain, uncounted."""
    x, scale, bias, _, _ = _gate_case(case)
    delta = _rows(6, 1024, x.dtype, seed=4).view(x.shape)
    with torch.enable_grad():
        s, out = ln.add_layer_norm(x, delta, scale, bias, EPS)
    assert torch.equal(s, x + delta) and torch.equal(out, _formula(x + delta, scale, bias, EPS))
    assert ln.add_layer_norm.launches == ln.add_layer_norm.launches_fused == 0


def test_counts_rise_and_never_fall(fake_card):
    x, scale, bias, _, delta = _gate_case("fused")
    seen = []
    for d in (None, delta, delta, None):
        ln.add_layer_norm(x, d, scale, bias, EPS)
        seen.append((ln.add_layer_norm.launches, ln.add_layer_norm.launches_fused))
    common.layer_norm(x.float(), scale, bias, EPS)  # the plain path counts nothing
    seen.append((ln.add_layer_norm.launches, ln.add_layer_norm.launches_fused))
    assert seen == [(1, 0), (2, 1), (3, 2), (4, 2), (4, 2)]


def _wave_batch(cfg, T=3200):
    r = np.random.RandomState(7)
    lens = torch.tensor([T, 2100])
    w = wavlm_prepare_batch(torch.from_numpy((r.randn(2, T) * 0.1).astype(np.float32)), lens,
                            cfg.do_normalize)
    return w, lens


def _model(family: str, dtype):
    """A small model of each family, pre-LN, with its widths for the gate."""
    if family == "wavlm":
        cfg = dataclasses.replace(WavLMConfig.tiny(64, 2, 4), do_stable_layer_norm=True)
        model = init_wavlm(cfg, torch.Generator().manual_seed(3))
        widths = (cfg.conv_dim[-1], cfg.hidden_size)
    elif family == "wav2vec2":
        cfg = Wav2Vec2Config.tiny(64, 3, 4)
        model = init_wav2vec2(cfg, torch.Generator().manual_seed(4))
        widths = (cfg.conv_dim[-1], cfg.hidden_size)
    else:
        cfg = WhisperConfig.tiny(32, 2, 4)
        model = init_whisper(cfg, torch.Generator().manual_seed(5))
        widths = (cfg.d_model,)
    return model.to(dtype), cfg, widths


def _forward(family, model, cfg):
    if family == "whisper":
        mel = torch.from_numpy(np.random.RandomState(8).randn(2, cfg.num_mel_bins, 3000)
                               .astype(np.float32)) * 0.3
        return model(mel)
    return model(*_wave_batch(cfg))


def _launches_a_forward(family, cfg) -> tuple[int, int]:
    """(launches, fused launches) of one forward of a two-clip batch."""
    if family == "whisper":
        # the encoder: 2 a layer and its final norm; the decoder: 3 a layer
        # and its final norm
        enc, dec = cfg.encoder_layers, cfg.decoder_layers
        return 2 * enc + 1 + 3 * dec + 1, enc
    # and the final norm and the feature projection's
    n = cfg.num_hidden_layers
    return 2 * n + 2, n


@pytest.mark.parametrize("family", ["wavlm", "wav2vec2", "whisper"])
def test_forward_launches_and_is_unchanged(fake_card, monkeypatch, family):
    """A bf16 forward through the fake card: 2 launches a pre-LN layer (the
    first norm, then the fused add and second norm), the final norm and the
    feature projection's; every hidden state bit for bit the plain run's."""
    model, cfg, widths = _model(family, torch.bfloat16)
    monkeypatch.setattr(ln, "WIDTHS", widths)
    got = _forward(family, model, cfg)
    launches = (ln.add_layer_norm.launches, ln.add_layer_norm.launches_fused)
    assert launches == _launches_a_forward(family, cfg)
    monkeypatch.setattr(ln, "_on_card", lambda t: False)
    want = _forward(family, model, cfg)
    assert (ln.add_layer_norm.launches, ln.add_layer_norm.launches_fused) == launches
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["wavlm", "wav2vec2", "whisper"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cpu_forward_unchanged(monkeypatch, family, dtype):
    """The models' CPU forwards, every hidden state, bit for bit what they
    were with the add and the norm written out at the call sites."""
    model, cfg, _ = _model(family, dtype)
    got = _forward(family, model, cfg)

    def written_out(x, delta, scale, bias, eps):
        s = x + delta
        return s, _formula(s, scale, bias, eps)

    for module in ("wavlm", "wav2vec2", "whisper"):
        monkeypatch.setattr(f"stutter_tpu_torch.models.{module}.add_layer_norm", written_out)
        monkeypatch.setattr(f"stutter_tpu_torch.models.{module}.layer_norm", _formula)
    want = _forward(family, model, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_finetune_step_launches_nothing(fake_card, monkeypatch):
    """A bf16 fine-tuning step's forward runs under autograd with parameters
    that require grad: every norm stays plain."""
    mcfg = dataclasses.replace(WavLMConfig.tiny(64, 2, 4), do_stable_layer_norm=True,
                               apply_spec_augment=False)
    monkeypatch.setattr(ln, "WIDTHS", (mcfg.conv_dim[-1], mcfg.hidden_size))
    cfg = FinetuneConfig(model=mcfg, n_classes=3, head_hidden=(16,), head_dropout=0.0,
                         activation_dtype=torch.bfloat16)
    trainer = FinetuneTrainer(cfg, device="cpu")
    r = np.random.RandomState(9)
    batch = [torch.from_numpy((r.randn(4, 3200) * 0.1).astype(np.float32)),
             torch.full((4,), 3200, dtype=torch.long), torch.tensor([0, 1, 2, 1]),
             torch.ones(4)]
    _, loss, _ = trainer.gradients([batch], np.ones(3, np.float32), normalize_in_graph=True)
    assert np.isfinite(float(loss))
    assert ln.add_layer_norm.launches == ln.add_layer_norm.launches_fused == 0


def test_projection_norm_takes_the_kernel_on_either_stems_frames(fake_card, monkeypatch):
    """The feature projection's norm takes the kernel on [B, L, C] frames
    as the fused stem writes them and on the plain stem's transposed view,
    which it copies to rows of their own first."""
    model, cfg, widths = _model("wavlm", torch.bfloat16)
    monkeypatch.setattr(ln, "WIDTHS", widths)
    frames = _rows(2 * 9, cfg.conv_dim[-1], torch.bfloat16).view(2, 9, -1)
    with torch.inference_mode():
        got = model.feature_projection(frames)
        assert ln.add_layer_norm.launches == 1
        want = model.feature_projection(frames.transpose(1, 2).contiguous().transpose(1, 2))
        assert ln.add_layer_norm.launches == 2
    assert torch.equal(got, want)
