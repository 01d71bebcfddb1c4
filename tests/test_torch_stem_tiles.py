"""The host side of the port's wgmma stem kernels, on the CPU.

``csrc/wavlm_stem.cu`` runs each conv layer of WavLM's stem as wgmma tiles
of 128 output frames, two CTAs a cluster sharing each weight tile, and the
512 channels in two passes of 256 with the first pass's h stashed as bf16.
The kernels run only on the card (chip_smoke.py holds them against the plain
version there); this file checks what they are built from: the packed
weight tiles round-trip to the JAX stem's weights and feed the plain
version the same convs, the grid covers every (clip, frame) row once, and
the stash leaves the layer norm's statistics bit for bit as one pass.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stutter_tpu_torch.models import wavlm as tw
from stutter_tpu_torch.ops import wavlm_stem as tstem

torch.set_num_threads(2)  # six xdist workers share the host

CSRC = Path(tstem.__file__).resolve().parent.parent / "csrc" / "wavlm_stem.cu"


def _layers(rng, C):
    """The conv layers of tests/test_stem_pallas.py:_make_layers at width C,
    as numpy."""
    layers, in_dim = [], 1
    for k in (10, 3, 3, 3, 3, 2, 2):
        layers.append({
            "w": rng.randn(C, in_dim, k).astype(np.float32) * (in_dim * k) ** -0.5,
            "b": rng.randn(C).astype(np.float32) * 0.1,
            "scale": 1.0 + 0.1 * rng.randn(C).astype(np.float32),
            "bias": 0.1 * rng.randn(C).astype(np.float32),
        })
        in_dim = C
    return layers


def _stem(layers, C):
    stem = tw.ConvFeatureEncoder(tw.WavLMConfig(conv_dim=(C,) * 7, conv_bias=True,
                                                feat_extract_norm="layer"))
    with torch.no_grad():
        for mod, p in zip(stem.layers, layers):
            mod.weight.copy_(torch.from_numpy(p["w"]))
            mod.bias.copy_(torch.from_numpy(p["b"]))
            mod.norm_scale.copy_(torch.from_numpy(p["scale"]))
            mod.norm_bias.copy_(torch.from_numpy(p["bias"]))
    return stem


@pytest.mark.parametrize("C", [128, 512])
def test_pack_round_trips_to_the_jax_weights(rng, C):
    layers = _layers(rng, C)
    weights, table = tstem.pack_stem_weights(_stem(layers, C).layers)
    assert weights.dtype == torch.bfloat16 and tuple(weights.shape) == (16 + 4 * 3 * C
                                                                      + 2 * 2 * C, C)
    for got, p in zip(tstem._layer_weights(weights), layers):
        want = torch.from_numpy(p["w"]).bfloat16().float()
        assert torch.equal(got, want)
    np.testing.assert_array_equal(table[:, 1].numpy(), np.stack([p["scale"] for p in layers]))
    np.testing.assert_array_equal(weights[10:16].float().numpy(), 0)


@pytest.mark.parametrize("C", [128, 512])
def test_tiles_are_k_major_and_swizzled(rng, C):
    """Tile (pass p, chunk c) of a conv layer: 256 (or C) rows of output
    channels, each 64 contraction values j * C_in + c, 16-byte group g of row
    n at g ^ (n % 8); the tiles follow each other pass-major, contiguous."""
    w = torch.from_numpy(rng.randn(C, C, 3).astype(np.float32)).bfloat16()
    flat = tstem.conv_tiles(w).reshape(-1)
    nb, chunks = min(C, 256), 3 * C // 64
    wt = w.permute(0, 2, 1).reshape(C, 3 * C)
    for p, c in ((0, 0), (C // nb - 1, chunks - 1), (0, chunks // 2)):
        tile = flat[(p * chunks + c) * nb * 64:][:nb * 64].view(nb, 8, 8)
        for n in (0, 1, 7, 8, nb - 1):
            for g in range(8):
                assert torch.equal(tile[n, g ^ (n % 8)], wt[p * nb + n, 64 * c + 8 * g:][:8])


def test_plain_version_convs_with_the_packed_weights(rng):
    """The plain version's first conv layers from the packed tiles equal the
    same convs on the bf16 weights (C = 128, T = 16 frames)."""
    C = 128
    layers = _layers(rng, C)
    weights, table = tstem.pack_stem_weights(_stem(layers, C).layers)
    wave = torch.from_numpy(rng.randn(2, 16 * 320 + 80).astype(np.float32) * 0.1)
    ours = tstem.wavlm_fused_stem_reference(wave, weights, table)
    x = wave.bfloat16()[:, None, :]
    for i, p in enumerate(layers):
        w = torch.from_numpy(p["w"]).bfloat16().float()
        h = F.conv1d(x.float(), w, stride=tstem._STRIDES[i]).bfloat16()
        h = h + table[i, 0].bfloat16()[None, :, None]
        x = tw.gelu(tw.layer_norm(h, table[i, 1], table[i, 2], 1e-5, dim=1))
    assert torch.equal(ours, x.transpose(1, 2).contiguous())


def test_plan_constants_match_the_kernel():
    src = CSRC.read_text()
    conv = src[src.index("namespace conv {"):src.index("}  // namespace conv")]
    assert int(re.search(r"kBM = (\d+);", conv).group(1)) == tstem.CONV_TILE_FRAMES
    assert int(re.search(r"kCluster = (\d+);", conv).group(1)) == tstem.CONV_CLUSTER
    assert int(re.search(r"kBN = (\d+);", conv).group(1)) == tstem._TILE_N
    assert int(re.search(r"kBK = (\d+);", conv).group(1)) == tstem._TILE_K


@pytest.mark.parametrize("T", [51_280, 481_360, 400, 51_417, 16_080, 1_360])
def test_plan_covers_every_row_once(T):
    """Each layer's tiles cover every (clip, frame) row exactly once, in
    whole clusters, with every window inside its own clip; 1 s clips
    (16,080) leave a tile of a cluster with no rows."""
    B = 3
    plan = tstem.conv_plan(T)
    assert [t for _, t, _ in plan] == tstem.stem_layer_lengths(T)[1:]
    empty_tiles = 0
    for (T_in, T_out, tiles), k in zip(plan, tstem._KERNELS[1:]):
        assert tiles % tstem.CONV_CLUSTER == 0
        seen = np.zeros((B, T_out), int)
        for b in range(B):
            for tile in range(tiles):
                rows = tile * tstem.CONV_TILE_FRAMES + np.arange(tstem.CONV_TILE_FRAMES)
                rows = rows[rows < T_out]
                empty_tiles += rows.size == 0
                seen[b, rows] += 1
                assert np.all(2 * rows + k - 1 < T_in)
        assert np.all(seen == 1)
    if T == 16_080:
        assert empty_tiles > 0


def _kernel_stats(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's layer-norm statistics of h [rows, 512] in its order: lane
    tig of a quad sums columns 8 nt + 2 tig + j, pass by pass, nt and j in
    order; the quad adds by xor 1, then xor 2; the mean, then the mean of
    squared deviations, likewise."""
    def quad_sum(x):  # x [rows, 512] -> [rows]
        lanes = []
        for tig in range(4):
            acc = torch.zeros(x.shape[0])
            for p in range(2):
                for nt in range(32):
                    for j in range(2):
                        acc = acc + x[:, 256 * p + 8 * nt + 2 * tig + j]
            lanes.append(acc)
        return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])

    mean = quad_sum(h) * (1.0 / 512)
    var = quad_sum((h - mean[:, None]) * (h - mean[:, None])) * (1.0 / 512)
    return mean, var


def test_two_pass_stash_equals_one_pass_layer_norm(rng):
    acc = torch.from_numpy(rng.randn(64, 512).astype(np.float32) * 3.0)
    bias = torch.from_numpy(rng.randn(512).astype(np.float32))
    h = (acc.bfloat16() + bias.bfloat16()).float()  # h = bf16(bf16(acc) + bf16(bias))
    # pass 0's h through the bf16 stash, pass 1's from the accumulators
    stashed = torch.cat([h[:, :256].bfloat16().float(), h[:, 256:]], dim=1)
    assert torch.equal(stashed, h)
    mean, var = _kernel_stats(stashed)
    mean1, var1 = _kernel_stats(h)
    assert torch.equal(mean, mean1) and torch.equal(var, var1)
    # and the statistics are the plain layer norm's up to f32 summation order
    torch.testing.assert_close(mean, h.mean(dim=1), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var, h.var(dim=1, unbiased=False), rtol=1e-5, atol=1e-6)
