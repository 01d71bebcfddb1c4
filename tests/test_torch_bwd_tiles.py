"""What the gated attention's backward decides in Python for its bf16 wgmma
kernels, with no card present, and its plain version against the JAX
package's Pallas VJP at the lengths those kernels' 64-row tiles make risky.

The CUDA kernels themselves run only on the card: ``chip_smoke.py``
([attn_bwd], [bwd_edges]) holds them to the plain version checked here.

Bars:
- the plain backward against ``jax.vjp`` of ``wavlm_attention_short_diff``
  (its blocks span the whole length, so it takes any L) or
  ``wavlm_attention_long_diff`` in interpret mode, on the same numpy inputs:
  ``REL_TOL`` of each gradient's max (``tests/test_torch_attention_bwd.py``'s
  bar, itself ``tests/test_attention_vjp.py``'s);
- the pure-Python pieces (grid order, clip groups, the dbias scratch) held
  to their definitions;
- the C entry's argument count against its ctypes signature;
- on the card path the wrapper runs no PyTorch arithmetic: D comes from
  the kernels.
"""

import contextlib
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from stutter_tpu.ops.wavlm_attention_vjp import (
    wavlm_attention_long_diff,
    wavlm_attention_short_diff,
)
from stutter_tpu_torch.ops import _build
from stutter_tpu_torch.ops import wavlm_attention as tattn
from tests.test_torch_attention_bwd import REL_TOL

torch.set_num_threads(2)  # six xdist workers share the host

CSRC = Path(_build.__file__).resolve().parent.parent / "csrc"
EDGE_LENGTHS = (37, 63, 64, 65, 127, 128, 129, 160)


def _inputs(L, seed, B=4, H=2, d=64):
    """Clip 0 has 2/3 of its keys, clip 1 none, clip 2 all of them and a gate
    of 0, clip 3 all of them."""
    rng = np.random.default_rng(seed)
    q, k = ((rng.standard_normal((B, H, L, d)) * 0.3).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((B, H, L, d)).astype(np.float32)
    bias = rng.standard_normal((H, L, L)).astype(np.float32)
    gate = rng.uniform(0.5, 2.0, (B, H, L)).astype(np.float32)
    gate[2] = 0.0
    mask = np.zeros((B, L), np.float32)
    mask[0, (2 * L) // 3:] = -1e9
    mask[1] = -1e9
    cot = rng.standard_normal((B, H, L, d)).astype(np.float32)
    return (q, k, v, bias, gate, mask), cot


def _against_jax(args, cot, f):
    out_j, vjp = jax.vjp(f, *map(jnp.asarray, args[:5]))
    grads_j = vjp(jnp.asarray(cot))
    t = [torch.from_numpy(a) for a in args]
    out = tattn.gated_relpos_attention(*t)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=2e-5, atol=2e-5)
    ours = tattn.gated_relpos_attention_backward(*t, out, torch.from_numpy(cot))
    for name, a, b in zip(("q", "k", "v", "position_bias", "gate"), ours, grads_j):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and np.isfinite(a).all(), name
        denom = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=REL_TOL, atol=REL_TOL * denom,
                                   err_msg=f"gradient mismatch: {name}")
    return ours


@pytest.mark.parametrize("L", EDGE_LENGTHS)
def test_plain_backward_matches_the_short_vjp_at_the_tile_edges(L):
    args, cot = _inputs(L, seed=200 + L)
    mask = jnp.asarray(args[5])
    ours = _against_jax(args, cot, lambda q, k, v, pb, gate: wavlm_attention_short_diff(
        q, k, v, pb, gate, mask, interpret=True))
    # the zero-gate clip still has a gate gradient, and adds nothing to dbias
    # beyond its gate; the fully padded clip's gradients are finite
    assert np.abs(ours[4][2].numpy()).max() > 0


def test_plain_backward_matches_the_long_vjp_at_a_64_row_block():
    args, cot = _inputs(192, seed=7, B=3)
    mask = jnp.asarray(args[5])
    _against_jax(args, cot, lambda q, k, v, pb, gate: wavlm_attention_long_diff(
        q, k, v, pb, gate, mask, block_q=64, interpret=True))


@pytest.mark.parametrize("B,H,L", [
    (32, 16, 160), (128, 16, 160), (8, 16, 160), (9, 16, 512), (4, 16, 1008),
    (12, 16, 1504), (1, 1, 5), (4, 3, 37), (5, 16, 64), (7, 12, 129), (100, 1, 64),
])
def test_clip_groups_by_their_definition(B, H, L):
    groups = tattn.clip_groups_for(B, H, L)
    per_group = -(-B // groups)
    assert 1 <= groups <= B
    assert (groups - 1) * per_group < B  # no group is empty
    assert -(-B // per_group) == groups  # the kernel's split gives the same count
    blocks = H * (-(-L // 64)) ** 2
    if groups > 1:  # split only for too few blocks, never below the clips a group keeps
        assert blocks * (groups - 1) < tattn.DBIAS_TARGET_BLOCKS
        assert per_group >= tattn.DBIAS_MIN_CLIPS
    shape = tattn.dbias_scratch_shape(H, L, groups)
    assert shape == (None if groups == 1 else (groups, H, L, L))
    assert tattn.dbias_scratch_shape(H, L, 1) is None


@pytest.mark.parametrize("B,H,L,groups", [
    (32, 16, 160, 4),   # the fine-tune CLI's 3 s batch: 144 tile blocks, 8 clips a group
    (9, 16, 512, 1),    # its 10 s bucket: 1024 tile blocks
    (4, 16, 1008, 1),
])
def test_clip_groups_at_the_cli_shapes(B, H, L, groups):
    assert tattn.clip_groups_for(B, H, L) == groups


@pytest.mark.parametrize("H,L", [(16, 160), (16, 512), (16, 1008), (3, 37)])
def test_backward_grid_order_is_the_forwards(H, L):
    """The dq and dk+dv kernels read slabs of the same [H, L, L] plane as the
    forward: the same order by its size."""
    expect = tattn.CLIP_FASTEST if 4 * H * L * L > tattn.CLIP_FASTEST_ABOVE_BYTES \
        else tattn.QUERY_TILE_FASTEST
    assert tattn.grid_order_for(H, L) == expect


def _c_declarations() -> dict:
    """Each extern "C" entry of csrc/*.cu and its argument count."""
    found = {}
    for src in CSRC.glob("*.cu"):
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return found


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_the_c_declaration(name):
    declared = _c_declarations()
    assert name in declared, f"no extern \"C\" {name} in {CSRC}"
    assert len(_build.SIGNATURES[name][0]) == declared[name]


class _Recorder(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.append(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


def test_card_path_computes_no_d_in_pytorch(monkeypatch):
    """Presented as the card's, the wrapper hands the kernels out and an
    empty D buffer, and calls no PyTorch arithmetic on the way."""
    args, cot = _inputs(40, seed=11)
    t = [torch.from_numpy(a) for a in args]
    t[:3] = [x.bfloat16() for x in t[:3]]
    out = tattn.gated_relpos_attention_reference(*t)
    do = torch.from_numpy(cot).bfloat16()
    stats = torch.zeros(2, *t[4].shape)
    calls = []

    def entry(*a):
        calls.append(a)
        return 0

    lib = types.SimpleNamespace(wavlm_gated_relpos_attention_bwd=entry)
    monkeypatch.setattr(tattn, "_device_kind", lambda q: "cuda")
    monkeypatch.setattr(_build, "kernel_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=None))
    monkeypatch.setattr(tattn.gated_relpos_attention_backward, "launches", 0)  # restored after
    with _Recorder() as rec:
        grads = tattn.gated_relpos_attention_backward(*t, out, do, stats)
    assert tattn.gated_relpos_attention_backward.launches == 1
    assert len(calls) == 1 and len(calls[0]) == len(_build.SIGNATURES[
        "wavlm_gated_relpos_attention_bwd"][0])
    c = calls[0]
    assert c[6] == do.data_ptr() and c[7] == stats.data_ptr() and c[8] == out.data_ptr()
    B, H, L, _ = t[0].shape
    assert c[16:20] == (B, H, L, tattn.clip_groups_for(B, H, L))
    assert c[20] in (4, 16) and c[21] == tattn.grid_order_for(H, L)
    arithmetic = {"sum", "mul", "__mul__", "float", "to", "matmul", "einsum", "copy_"}
    assert not arithmetic & set(rec.names), sorted(set(rec.names))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32] * 2


def test_cpu_path_is_the_plain_backward_bit_for_bit():
    args, cot = _inputs(65, seed=12, B=3)
    t = [torch.from_numpy(a) for a in args]
    out = tattn.gated_relpos_attention(*t)
    got = tattn.gated_relpos_attention_backward(*t, out, torch.from_numpy(cot))
    ref = tattn.gated_relpos_attention_backward_reference(*t, out, torch.from_numpy(cot))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_launch_backward_needs_cuda_tensors():
    args, cot = _inputs(16, seed=13)
    t = [torch.from_numpy(a) for a in args]
    out = tattn.gated_relpos_attention(*t)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.launch_backward(*t, out, torch.from_numpy(cot), torch.zeros(2, 4, 2, 16),
                              tattn.QUERY_TILE_FASTEST, 1)
