"""The positional conv's kernel wrapper on the CPU.

The CUDA kernel (``csrc/pos_conv.cu``) runs only on the card, where
``chip_smoke.py`` [pos_conv] holds it against the plain version. Here: the
plain version equals ``PosConvEmbedding``'s own path in f32 (PyTorch's CPU
bf16 grouped conv1d is wrong at 8 channels a group, so the small widths are
compared in f32); the weight pack's layout and its round trip; the gate
(bf16, no autograd, 128 taps, 64 or 120 channels a group, on the card)
deciding, with no flag, where the module takes the kernel; and both models'
CPU forwards unchanged.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
from stutter_tpu_torch.models import wavlm as tw
from stutter_tpu_torch.models.common import gelu
from stutter_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from stutter_tpu_torch.ops import pos_conv as tpc
from stutter_tpu_torch.weights.convert import init_wav2vec2, init_wavlm

torch.set_num_threads(2)  # six xdist workers share the host


def _module(D: int, groups: int, kernel: int = 128, dtype=torch.float32) -> tw.PosConvEmbedding:
    cfg = dataclasses.replace(tw.WavLMConfig.tiny(D), num_conv_pos_embeddings=kernel,
                              num_conv_pos_embedding_groups=groups)
    module = tw.PosConvEmbedding(cfg)
    g = torch.Generator().manual_seed(D + kernel)
    with torch.no_grad():
        module.weight.copy_(torch.randn(module.weight.shape, generator=g)
                            * (module.weight.shape[1] * kernel) ** -0.5)
        module.bias.copy_(torch.randn(D, generator=g) * 0.1)
    return module.to(dtype)


def _hidden(B: int, L: int, D: int, dtype=torch.float32) -> torch.Tensor:
    """[B, L, D] ~N(0, 0.25), clip b's frames from an odd count on zeroed."""
    r = np.random.RandomState(L + D)
    x = torch.from_numpy((r.randn(B, L, D) * 0.5).astype(np.float32))
    for b in range(1, B):
        x[b, max(1, L // (b + 1)) | 1:] = 0.0
    return x.to(dtype)


@pytest.mark.parametrize("groups,width", [(4, 8), (4, 16)])
@pytest.mark.parametrize("L", [1, 40, 150, 300])
def test_reference_equals_the_modules_plain_path(groups, width, L):
    """hidden + PosConvEmbedding's embedding, in f32, at 4 x 8 and 4 x 16:
    frames shorter than the 64-frame pad, and longer than a 256-frame tile."""
    module = _module(groups * width, groups)
    x = _hidden(3, L, groups * width)
    want = module(x)
    assert torch.equal(tpc.pos_conv_residual_reference(x, module.weight, module.bias, groups),
                       want)
    # the CPU wrapper is the reference on the packed (bf16) weights
    got = tpc.pos_conv_residual(x, tpc.pack_pos_conv_weights(module.weight), module.bias.float(),
                                groups)
    rounded = tpc.pos_conv_residual_reference(x, module.weight.to(torch.bfloat16), module.bias,
                                              groups)
    assert torch.equal(got, rounded)


def test_reference_rounds_where_the_bf16_path_rounds():
    """In bf16: the embedding rounded to bf16, then an f32 add rounded once."""
    module = _module(128, 2, dtype=torch.bfloat16)
    x = _hidden(2, 90, 128, torch.bfloat16)
    y = F.conv1d(x.float().transpose(1, 2), module.weight.float(), padding=64, groups=2)
    y = (y + module.bias.float()[None, :, None])[:, :, :90]
    want = (x.float() + F.gelu(y).to(torch.bfloat16).float().transpose(1, 2)).to(torch.bfloat16)
    got = tpc.pos_conv_residual_reference(x, module.weight, module.bias, 2)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("width", [8, 16, 64, 120])
def test_pack_round_trip_and_layout(width):
    """The pack holds each weight once, with no padding (120 is 15 whole
    8-channel chunks), at [g, p * chunks + k, h, n, i] = W[g Cg + n, 8 k + i,
    2 p + h]; unpacking gives the bf16 weight back."""
    G = 2
    w = torch.randn(G * width, width, 128, generator=torch.Generator().manual_seed(width))
    packed = tpc.pack_pos_conv_weights(w)
    chunks = width // 8
    assert packed.shape == (G, 64 * chunks, 2, width, 8) and packed.dtype == torch.bfloat16
    assert packed.numel() == w.numel() and packed.is_contiguous()
    assert torch.equal(tpc.unpack_pos_conv_weights(packed), w.to(torch.bfloat16))
    r = np.random.RandomState(width)
    for _ in range(50):
        g, p, k, h, n, i = (int(r.randint(m)) for m in (G, 64, chunks, 2, width, 8))
        assert packed[g, p * chunks + k, h, n, i] == w[g * width + n, 8 * k + i, 2 * p + h].to(
            torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 120, 16), (2, 60, 128)])
def test_pack_refuses_what_the_kernel_cannot_read(shape):
    with pytest.raises(ValueError):
        tpc.pack_pos_conv_weights(torch.zeros(shape))


@pytest.fixture
def kernel_calls(monkeypatch):
    """Treats the CPU as the card in the gate and records what the module
    hands the kernel wrapper (its CPU path, the plain version, runs)."""
    calls = []
    real = tw.pos_conv_residual

    def spy(hidden, *args):
        calls.append(tuple(hidden.shape))
        return real(hidden, *args)

    monkeypatch.setattr(tw, "pos_conv_residual", spy)
    monkeypatch.setattr(tpc, "_on_card", lambda t: t.device.type in ("cpu", "cuda"))
    return calls


@pytest.mark.parametrize("case,width,kernel,taken", [
    ("bf16", 64, 128, True), ("bf16", 120, 128, True), ("f32", 64, 128, False),
    ("f32", 120, 128, False), ("bf16", 80, 128, False), ("bf16", 64, 16, False),
    ("bf16", 120, 126, False), ("grad", 64, 128, False), ("grad", 120, 128, False),
    ("grad_off", 64, 128, True), ("cpu_device", 64, 128, False),
    ("cpu_device", 120, 128, False)])
def test_selection_follows_the_gate(kernel_calls, monkeypatch, case, width, kernel, taken):
    """Without a flag, the module takes the kernel on bf16 input and weights
    with 128 taps and 64 or 120 channels a group, with grad off or nothing
    requiring it; f32, another width (XLS-R 1B's 80) or conv width, autograd
    and a device that is not the card keep the plain path, whose result the
    kernel's plain version matches."""
    if case == "cpu_device":
        monkeypatch.setattr(tpc, "_on_card", lambda t: t.device.type == "cuda")
    f32 = case.startswith("f32")
    module = _module(2 * width, 2, kernel, torch.float32 if f32 else torch.bfloat16)
    x = _hidden(2, 70, 2 * width, torch.float32 if f32 else torch.bfloat16)
    if case.startswith("grad"):
        module.weight.requires_grad_(True)
    with torch.no_grad() if case == "grad_off" else torch.enable_grad():
        out = module(x)
    assert kernel_calls == ([(2, 70, 2 * width)] if taken else [])
    plain = module.plain(x)
    assert out.dtype == plain.dtype == x.dtype
    # the plain path rounds the conv to bf16 before the bias, the kernel's
    # plain version does not: a flipped rounding of the embedding, then of
    # the sum, two bf16 steps of |out| < 2
    tol = 1 / 32 if x.dtype == torch.bfloat16 else 0.0
    assert (out.float() - plain.float()).abs().max() <= tol
    assert out.requires_grad == (case == "grad")


def _small_wavlm(dtype):
    cfg = dataclasses.replace(tw.WavLMConfig.tiny(128, 1, 2), num_conv_pos_embedding_groups=2)
    return init_wavlm(cfg, torch.Generator().manual_seed(3)).to(dtype), cfg


def _batch(cfg, T=3200):
    r = np.random.RandomState(7)
    lens = torch.tensor([T, 2100])
    w = wavlm_prepare_batch(torch.from_numpy((r.randn(2, T) * 0.1).astype(np.float32)), lens,
                            cfg.do_normalize)
    return w, lens


@pytest.mark.parametrize("call,taken", [("encode", True), ("forward", True),
                                        ("pooled_states", False)])
def test_model_calls_take_the_kernel_where_the_gate_passes(kernel_calls, call, taken):
    """A bf16 WavLM at 64 channels a group: encode and forward (inference
    mode) make one kernel call; the differentiable pooled_states keeps the
    plain path."""
    model, cfg = _small_wavlm(torch.bfloat16)
    w, lens = _batch(cfg)
    if call == "pooled_states":
        for p in model.parameters():
            p.requires_grad_(True)
        out = model.pooled_states(w, lens)
    elif call == "forward":
        out = model(w, lens)[1]
    else:
        out = model.encode(w, (1, 0), lens)
    assert torch.isfinite(out.float()).all()
    assert len(kernel_calls) == int(taken)


def _previous_pos_conv(self, x):
    """PosConvEmbedding's embedding as the models added it to hidden before
    the kernel: the callers computed hidden + this."""
    y = F.conv1d(x.transpose(1, 2), self.weight, padding=self.kernel // 2,
                 groups=self.groups).float()
    y = y + self.bias.float()[None, :, None]
    if self.kernel % 2 == 0:
        y = y[:, :, :-1]
    return gelu(y).to(x.dtype).transpose(1, 2)


@pytest.mark.parametrize("family", ["wavlm", "wav2vec2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_models_cpu_forward_unchanged(monkeypatch, family, dtype):
    """Both models' CPU forwards, every hidden state, bit for bit what they
    were with hidden + the module's embedding at the call site."""
    if family == "wavlm":
        model, cfg = _small_wavlm(dtype)
    else:
        cfg = dataclasses.replace(Wav2Vec2Config.tiny(64, 2, 4), num_conv_pos_embeddings=128,
                                  num_conv_pos_embedding_groups=4)
        model = init_wav2vec2(cfg, torch.Generator().manual_seed(4)).to(dtype)
    w, lens = _batch(cfg)
    got = model(w, lens)
    monkeypatch.setattr(tw.PosConvEmbedding, "forward",
                        lambda self, x: x + _previous_pos_conv(self, x))
    want = model(w, lens)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
