"""Check and time the bf16 wgmma attention tiles on a CUDA card (flash_mha,
flash_mha_bias, the WavLM gated attention and its backward), the Whisper
log-mel and the fused WavLM stem, beside an earlier checkout's kernels and,
where there is one, ``scaled_dot_product_attention``.

    python -m stutter_tpu_torch.cli.flash_tiles_ab [--prev_root DIR] [--runs 20] \\
        [--kernels all|flash|gated|bwd|logmel|stem|probes] [--skip_timing]

1. Prints what ``ptxas -v`` said of the bf16 tiles' kernels at the build
   (registers, spills, stack, per instantiation) and any "wgmma
   serialized" warning.
2. Holds ``flash_mha`` and ``flash_mha_bias`` (bf16) against their plain
   versions over ragged lengths and key counts, and the gated attention
   (bf16, output and row statistics) over ragged lengths in both grid
   orders, with a fully padded clip and a clip whose gate is 0, and the
   gated attention's backward (bf16: dq, dk, dv, dbias, dgate) over the same
   lengths and 512 and 1008, in both grid orders, with one and two groups of
   clips in the dbias kernel and the bias through both copy widths; a case
   that disagrees prints a map of its errors by 16-row and 8-column block (or
   the gradient that disagrees) and the run fails.
3. Times, with CUDA events and in turns, each kernel through its wrapper
   (``ms``) and through its bare C entry point (``bare_ms``), the kernel of
   the checkout at ``--prev_root`` through the same entry point (built from
   that checkout's sources into its own build directory) and the library
   call: flash_mha at the Whisper encoder's shape and flash_mha_bias at the
   two long WavLM buckets; the gated attention at the 3 s, 20 s and 30 s
   buckets, also in the grid order it does not take. Per launch (as
   ``chip_smoke.py`` times every kernel; the host's time to enqueue the
   launch lies inside the events) and per launch of 8 enqueued back to back
   (``queued_ms``: the device's time alone). ``--prev_root`` is a directory
   holding an earlier commit of this repository, e.g. ``git archive
   <commit> | tar -x -C <dir>``.

4. Times the backward at the fine-tune CLI's 32 x 16 x 160, 9 x 16 x 512 and
   4 x 16 x 1008 the same way: through its wrapper, its bare C entry, the
   other grid order, one clip group and twice the groups, the earlier
   checkout's bare C entry (whose ABI, told apart by its argument count,
   takes D: computed once, outside the timed window) and, as a yardstick
   for dq, dk and dv alone, the maskless bf16 backward of
   ``scaled_dot_product_attention`` (it computes neither dgate nor dbias);
   then prints the profiler's per-kernel device times of one call (given
   ``--prev_root``, also of the earlier kernel with its D reduction in
   PyTorch, with ``--skip_timing`` too).

5. ``--kernels logmel`` (alone, not part of ``all``): holds the log-mel
   wrapper to its plain version at 16 x 30 s, 80 and 128 mels, and reports
   how far it and the plain version lie from the float64 log-mel on a tone
   made with f32 time stamps; prints the profiler's split of one call,
   launch by launch, of the earlier checkout's log-mel as its wrapper ran
   it (the reflect pad, its kernel through its own C signature with its
   [400, 402] basis, the epilogue in PyTorch) and of this one's; then times
   both and the plain version in turns, per launch and with 8 launches
   queued.
6. ``--kernels stem`` (alone): the same for the fused stem at 128 x 3 s and
   12 x 30 s, each checked against the plain version; the earlier kernel is
   called through its own C signature with its tap-major weight packing, and
   the split is by layer; beside them, cuBLAS's time for layer 1's product
   alone as a GEMM (its im2col rows made beforehand), a yardstick for the
   tensor cores' share.
7. ``--kernels probes`` (alone): the two attention probes (the int8 probe's
   prologue and main kernel, the four softmax variants) on the wgmma tiles:
   their ``ptxas`` rows, the opcodes of their SASS (``cuobjdump -sass``:
   wgmma in every kernel, no ``mma.sync``, and the chain's instructions per
   score in each pass's loop), each held to its plain version at the
   probes' two cases and ragged lengths (the int8 operands bit-equal), then
   timed in turns at the probes' cases through the wrappers, the bare C
   entries, the earlier checkout's C entries (its int8 prologue padded to
   its own ``KEY_ALIGN``, read from its ``ops/attn_probes.py``) and the
   incumbent ``gated_relpos_attention``, per launch and with 8 queued.

The last line is one JSON object with the times; the card's name and power
limit are in it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

BF16_MAX_ABS, BF16_COSINE = 2e-2, 1e-5  # chip_smoke.py's bars for these kernels
LOGMEL_MAX_ABS = 1e-4  # chip_smoke.py's bars for the log-mel and the fused stem
STEM_COSINE, STEM_NRMSE = 5e-4, 0.03
QUEUED_LAUNCHES = 8  # launches between two events in the second timing
TIMED = [("flash_mha", 16, 20, 1500), ("flash_mha_bias", 12, 16, 1504),
         ("flash_mha_bias", 19, 16, 1008)]
# the gated attention's buckets (B, H, L): 3 s, 20 s and 30 s
GATED_TIMED = [(128, 16, 160), (19, 16, 1008), (12, 16, 1504)]
STATS_MAX_ABS = 1e-3  # chip_smoke.py's bar for the row statistics
# chip_smoke.py's bars for the bf16 backward, per gradient: max-abs error over
# the plain result's max, and cosine distance
BWD_BF16_REL, BWD_BF16_COSINE = 2e-2, 1e-4
BWD_EDGE_LENGTHS = (37, 63, 64, 65, 127, 128, 129, 160, 512, 1008)
# the backward's shapes (B, H, L): the fine-tune CLI's 3 s batch, its 10 s
# bucket, a ragged long length
BWD_TIMED = [(32, 16, 160), (9, 16, 512), (4, 16, 1008)]
# the log-mel's path shapes (clips, mel bins): a Whisper batch of 16 x 30 s at
# large-v2's 80 and large-v3's 128 mels
LOGMEL_TIMED = [(16, 80), (16, 128)]
# the fused stem's buckets (clips, samples): 128 x 3 s and 12 x 30 s
STEM_TIMED = [(128, 51_280), (12, 481_360)]
# chip_smoke.py's bars for the probes against their plain versions
PROBE_INT8_MAX_ABS, PROBE_INT8_COSINE = 5e-2, 2e-4
PROBE_VARIANT_MAX_ABS = 2e-2
PROBE_VARIANT_COSINE = {"A_incumbent": 1e-5, "B_postnorm": 5e-5, "C_bf16chain": 1e-5,
                        "D_both": 5e-5}
# the probes' cases (clips, frames), 16 heads: their CLIs' two defaults, timed
PROBE_TIMED = [(30, 1008), (25, 1504)]
# checked only: under, at and past one 64-key tile, and 64 k + 1
PROBE_EDGES = [(3, 37), (2, 64), (2, 65), (2, 129), (4, 1025)]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--prev_root", default=None)
    parser.add_argument("--runs", type=int, default=20)
    parser.add_argument("--kernels", default="all",
                        choices=("all", "flash", "gated", "bwd", "logmel", "stem", "probes"))
    parser.add_argument("--skip_timing", action="store_true")
    return parser.parse_args(argv)


def load_prev_library(root: Path):
    """The kernel library of the checkout at ``root``, built by its own
    ``ops/_build.py`` (loaded by path, under another module name)."""
    path = root / "stutter_tpu_torch" / "ops" / "_build.py"
    spec = importlib.util.spec_from_file_location("prev_stutter_build", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.kernel_library()


def c_call(torch, lib, name, q, k, v, extra):
    """Launch a kernel library's flash_mha or flash_mha_bias (bf16) through
    its bare C entry point (with ab_vec where its signature has it)."""
    out = torch.empty_like(q)
    B, H, L, _ = q.shape
    fn = getattr(lib, name)
    shape = [B, H, L]
    if name == "flash_mha_bias" and len(fn.argtypes) == 14:
        shape.append(16 if L % 4 == 0 and extra.data_ptr() % 16 == 0 else 4)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if extra is None else extra.data_ptr(), out.data_ptr(),
            *shape, q.stride(0), q.stride(1), q.stride(2), 1,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    return out


def c_gated_call(torch, lib, q, k, v, bias, gate, mask):
    """Launch a kernel library's gated attention (bf16, no statistics)
    through its bare C entry point: without (an earlier checkout's), or
    with, the bf16 tiles' vector width and grid order."""
    out = torch.empty_like(q)
    B, H, L, _ = q.shape
    fn = lib.wavlm_gated_relpos_attention
    tiles = []
    if len(fn.argtypes) == 18:
        from stutter_tpu_torch.ops import wavlm_attention as attn
        from stutter_tpu_torch.ops._attention import vector_bytes

        tiles = [vector_bytes(bias, mask), attn.grid_order_for(H, L)]
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), gate.data_ptr(),
            mask.data_ptr(), out.data_ptr(), None, B, H, L, *tiles, q.stride(0), q.stride(1),
            q.stride(2), 1, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wavlm_gated_relpos_attention failed: CUDA error {rc}")
    return out


def cosine_distance(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(1.0 - (a @ b) / (a.norm() * b.norm()))


def error_map(torch, out, ref) -> str:
    """Max-abs error of clip 0, head 0 by block of 16 rows and 8 columns."""
    err = (out[0, 0].float() - ref[0, 0].float()).abs()
    L = err.shape[0]
    lines = []
    for r0 in range(0, min(L, 128), 16):
        row = [float(err[r0:r0 + 16, c0:c0 + 8].max()) for c0 in range(0, 64, 8)]
        lines.append(f"    rows {r0:4d}+16: " + " ".join(f"{x:8.1e}" for x in row))
    return "\n".join(lines)


def make_qkv(torch, g, B, H, L, transposed=True):
    def one():
        if transposed:  # [B, L, H, 64] projections viewed [B, H, L, 64], as the models pass them
            return (torch.randn(B, L, H, 64, device="cuda", generator=g) * 0.5) \
                .bfloat16().transpose(1, 2)
        return (torch.randn(B, H, L, 64, device="cuda", generator=g) * 0.5).bfloat16()
    return one(), one(), one()


def check_cases(torch, mha, verbose: bool = True) -> tuple[int, int, dict]:
    """Hold the bf16 kernels to their plain versions where the 64- and
    128-row tiles are most likely to be wrong. Returns (cases, cases that
    disagree, each kernel's worst max-abs error); prints a line a case when
    ``verbose``, else only the cases that disagree."""
    g = torch.Generator(device="cuda").manual_seed(3)
    cases, failures = 0, 0
    worst = {"flash_mha": 0.0, "flash_mha_bias": 0.0}

    def report(name, shape, extra, out, ref):
        nonlocal cases, failures
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all())
        laid_out = out.shape == ref.shape and out.dtype == ref.dtype
        max_abs = float((out.float() - ref.float()).abs().max())
        cos = cosine_distance(out.float(), ref.float())
        ok = finite and laid_out and max_abs <= BF16_MAX_ABS and cos <= BF16_COSINE
        cases += 1
        worst[name] = max(worst[name], max_abs)
        if verbose or not ok:
            print(f"[check] {name} {shape} {extra} finite={finite} max_abs={max_abs:.3e} "
                  f"cosine={cos:.3e} {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            failures += 1
            print(error_map(torch, out, ref), flush=True)

    # structured inputs first: they tell a wrong descriptor from a wrong softmax
    q, k, v = make_qkv(torch, g, 1, 1, 64)
    zero = torch.zeros_like(q)
    report("flash_mha", "1x1x64", "q=0 (out = mean of v)", mha.flash_mha(zero, k, v),
           mha.flash_mha_reference(zero, k, v))
    eye = torch.eye(64, device="cuda").bfloat16()[None, :, None, :].transpose(1, 2)
    report("flash_mha", "1x1x64", "v=I (out = probabilities)", mha.flash_mha(q * 4, k, eye),
           mha.flash_mha_reference(q * 4, k, eye))

    for L in (64, 65, 127, 128, 129, 37, 1008, 1500, 1504):
        B, H = (2, 3) if L > 200 else (3, 5)
        q, k, v = make_qkv(torch, g, B, H, L)
        report("flash_mha", f"{B}x{H}x{L}", "kv=all", mha.flash_mha(q, k, v),
               mha.flash_mha_reference(q, k, v))
        for valid in (0, 1, 63, 64, 65, L):
            kv = torch.tensor([min(valid, L), L, max(L - 1, 0)][:B], dtype=torch.int32,
                              device="cuda")
            report("flash_mha", f"{B}x{H}x{L}", f"kv={kv.tolist()}", mha.flash_mha(q, k, v, kv),
                   mha.flash_mha_reference(q, k, v, kv))
        ab = torch.randn(B, H, L, L, device="cuda", generator=g)
        ab[:, :, :, L - L // 3:] += -1e9  # keys masked, as WavLM's short clips mask them
        ab[0] = torch.randn(H, L, L, device="cuda", generator=g)
        report("flash_mha_bias", f"{B}x{H}x{L}", f"vec={mha.ab_vector_bytes(ab)}",
               mha.flash_mha_bias(q, k, v, ab), mha.flash_mha_bias_reference(q, k, v, ab))
        if L % 4 == 0:  # the same through the element-wise copies: ab off 16-byte alignment
            shifted = torch.empty(ab.numel() + 1, device="cuda")[1:].view_as(ab).copy_(ab)
            report("flash_mha_bias", f"{B}x{H}x{L}", f"vec={mha.ab_vector_bytes(shifted)}",
                   mha.flash_mha_bias(q, k, v, shifted),
                   mha.flash_mha_bias_reference(q, k, v, shifted))
    # a contiguous [B, H, L, 64] input, and a grid of more than 65,535 blocks
    q, k, v = make_qkv(torch, g, 2, 3, 129, transposed=False)
    report("flash_mha", "2x3x129", "contiguous", mha.flash_mha(q, k, v),
           mha.flash_mha_reference(q, k, v))
    q, k, v = make_qkv(torch, g, 3500, 20, 64)
    report("flash_mha", "3500x20x64", "70000 blocks", mha.flash_mha(q, k, v),
           mha.flash_mha_reference(q, k, v))
    return cases, failures, worst


def gated_inputs(torch, g, B, H, L, lengths, transposed=True):
    """The gated attention's operands: q, k, v as ``make_qkv`` gives them,
    bias [H, L, L], gate [B, H, L] in [0, 2) and the key mask of
    ``lengths``."""
    q, k, v = make_qkv(torch, g, B, H, L, transposed)
    bias = torch.randn(H, L, L, device="cuda", generator=g)
    gate = torch.rand(B, H, L, device="cuda", generator=g) * 2
    mask = torch.where(torch.arange(L, device="cuda")[None] < lengths[:, None], 0.0, -1e9) \
        .float().contiguous()
    return q, k, v, bias, gate, mask


def check_gated_cases(torch, attn, verbose: bool = True) -> tuple[int, int, float, float]:
    """Hold the gated attention's bf16 tiles, in both grid orders, to the
    plain version, output and row statistics, at ragged lengths around the
    64- and 128-row edges and at the 20 s bucket: clip 0 has every key,
    clip 1 half of them, clip 2 none, clip 3 every key and a gate of 0; the
    bias through its 16-byte copies and, off 16-byte alignment, its
    element-wise ones; a contiguous input. Returns (cases, cases that
    disagree, worst max-abs error of the output, of the statistics)."""
    from stutter_tpu_torch.ops._attention import vector_bytes

    g = torch.Generator(device="cuda").manual_seed(4)
    cases, failures, worst, worst_stats = 0, 0, 0.0, 0.0

    def run(L, args, what, order):
        nonlocal cases, failures, worst, worst_stats
        B, H = args[0].shape[:2]
        stats = torch.empty(2, B, H, L, device="cuda")
        out = attn.launch_tiles(*args, stats, order)
        ref = attn.gated_relpos_attention_reference(*args)
        ref_stats = attn.attention_row_stats_reference(*args[:2], *args[3:])
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all())
        max_abs = float((out.float() - ref.float()).abs().max())
        cos = cosine_distance(out.float(), ref.float())
        stats_err = float((stats - ref_stats).abs().max())
        ok = (finite and out.stride() == args[0].stride() and max_abs <= BF16_MAX_ABS
              and cos <= BF16_COSINE and stats_err <= STATS_MAX_ABS)
        cases += 1
        worst, worst_stats = max(worst, max_abs), max(worst_stats, stats_err)
        if verbose or not ok:
            print(f"[check] gated {B}x{H}x{L} {what} order={order} "
                  f"vec={vector_bytes(args[3], args[5])} finite={finite} "
                  f"max_abs={max_abs:.3e} cosine={cos:.3e} stats_max_abs={stats_err:.3e} "
                  f"{'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            failures += 1
            print(error_map(torch, out, ref), flush=True)

    for L in (37, 63, 64, 65, 127, 128, 129, 160, 1008):
        B, H = 4, (3 if L > 200 else 5)
        lengths = torch.tensor([L, max(L // 2, 1), 0, L], device="cuda")
        args = gated_inputs(torch, g, B, H, L, lengths)
        args[4][3] = 0.0
        for order in (attn.QUERY_TILE_FASTEST, attn.CLIP_FASTEST):
            run(L, args, "", order)
        if L % 4 == 0:  # the bias off 16-byte alignment: element-wise copies
            bias = args[3]
            shifted = torch.empty(bias.numel() + 1, device="cuda")[1:].view_as(bias).copy_(bias)
            run(L, (*args[:3], shifted, *args[4:]), "bias+4B", attn.CLIP_FASTEST)
    lengths = torch.tensor([129, 100, 0], device="cuda")
    args = gated_inputs(torch, g, 3, 4, 129, lengths, transposed=False)
    run(129, args, "contiguous", attn.QUERY_TILE_FASTEST)
    return cases, failures, worst, worst_stats


def bwd_inputs(torch, g, B, H, L, lengths, transposed=True, zero_gate_clip=None):
    """The backward's operands: the gated inputs (clip ``zero_gate_clip``'s
    gate 0), the forward's output and row statistics, and a do laid out
    like q."""
    from stutter_tpu_torch.ops import wavlm_attention as attn

    args = gated_inputs(torch, g, B, H, L, lengths, transposed)
    if zero_gate_clip is not None:
        args[4][zero_gate_clip] = 0.0

    stats = torch.empty(2, B, H, L, device="cuda")
    out = attn.gated_relpos_attention(*args, stats)
    do = make_qkv(torch, g, B, H, L, transposed)[0]
    return args, out, do, stats


def compare_grads(torch, got, ref) -> tuple[bool, dict]:
    """Each gradient against the plain backward's: finite, shaped and typed
    alike, max-abs error over the plain result's max and cosine distance
    within the bf16 bars. Returns (all agree, {name: (rel, cosine)})."""
    ok, errs = True, {}
    for name, a, b in zip(("dq", "dk", "dv", "dbias", "dgate"), got, ref):
        same = a.shape == b.shape and a.dtype == b.dtype and bool(torch.isfinite(a).all())
        rel = float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())
        cos = cosine_distance(a.float(), b.float())
        errs[name] = (rel, cos)
        ok = ok and same and rel <= BWD_BF16_REL and cos <= BWD_BF16_COSINE
    return ok, errs


def check_bwd_cases(torch, attn, verbose: bool = True) -> tuple[int, int, float]:
    """Hold the bf16 backward to the plain backward at ragged lengths around
    the tiles' 64-row edges and at 512 and 1008: clip 0 has every key, clip
    1 half of them, clip 2 none, clip 3 every key and a gate of 0; the dq
    and dk+dv kernels in both grid orders; the dbias kernel with one group
    of clips and with two (partial planes added by a second kernel); the
    f32 planes through their 16-byte and, with the bias off 16-byte
    alignment, their element-wise copies; a contiguous input. Returns
    (cases, cases that disagree, the worst max-abs error over the plain
    result's max)."""
    from stutter_tpu_torch.ops._attention import vector_bytes

    g = torch.Generator(device="cuda").manual_seed(8)
    cases, failures, worst = 0, 0, 0.0

    def run(L, args, out, do, stats, what, order, groups):
        nonlocal cases, failures, worst
        got = attn.launch_backward(*args, out, do, stats, order, groups)
        ref = attn.gated_relpos_attention_backward_reference(*args, out, do)
        torch.cuda.synchronize()
        ok, errs = compare_grads(torch, got, ref)
        ok = ok and all(t.stride() == args[0].stride() for t in got[:3])
        cases += 1
        worst = max([worst] + [rel for rel, _ in errs.values()])
        if verbose or not ok:
            B, H = args[0].shape[:2]
            print(f"[check] bwd {B}x{H}x{L} {what} order={order} groups={groups} "
                  f"vec={vector_bytes(args[3], args[5])} "
                  + " ".join(f"{n}={r:.2e}/{c:.2e}" for n, (r, c) in errs.items())
                  + f" {'ok' if ok else 'DISAGREES'}", flush=True)
        if not ok:
            failures += 1

    for L in BWD_EDGE_LENGTHS:
        B, H = 4, (2 if L > 200 else 3)
        lengths = torch.tensor([L, max(L // 2, 1), 0, L], device="cuda")
        args, out, do, stats = bwd_inputs(torch, g, B, H, L, lengths, zero_gate_clip=3)
        for order in (attn.QUERY_TILE_FASTEST, attn.CLIP_FASTEST):
            run(L, args, out, do, stats, "", order, 1)
        run(L, args, out, do, stats, "", attn.grid_order_for(H, L), 2)
        if L % 4 == 0:  # the bias off 16-byte alignment: element-wise copies
            bias = args[3]
            shifted = torch.empty(bias.numel() + 1, device="cuda")[1:].view_as(bias).copy_(bias)
            run(L, (*args[:3], shifted, *args[4:]), out, do, stats, "bias+4B",
                attn.CLIP_FASTEST, 2)
    lengths = torch.tensor([129, 100, 0], device="cuda")
    args, out, do, stats = bwd_inputs(torch, g, 3, 4, 129, lengths, transposed=False)
    run(129, args, out, do, stats, "contiguous", attn.QUERY_TILE_FASTEST, 3)
    return cases, failures, worst


def c_bwd_call(torch, lib, args, out, do, stats, dsum=None):
    """Launch a kernel library's bf16 backward through its bare C entry
    point: an earlier checkout's takes D (``dsum``, computed by the caller),
    the current one computes it and takes ``out``, the clip groups, the
    copy width and the grid order."""
    from stutter_tpu_torch.ops import wavlm_attention as attn
    from stutter_tpu_torch.ops._attention import vector_bytes

    q, k, v, bias, gate, mask = args
    B, H, L, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    dgate = torch.empty(B, H, L, device="cuda")
    dbias = torch.empty(H, L, L, device="cuda")
    fn = lib.wavlm_gated_relpos_attention_bwd
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), gate.data_ptr(),
            mask.data_ptr(), do.data_ptr(), stats.data_ptr()]
    grads = [dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dgate.data_ptr(), dbias.data_ptr()]
    strides = [q.stride(0), q.stride(1), q.stride(2), 1, torch.cuda.current_stream().cuda_stream]
    if len(fn.argtypes) == 22:
        rc = fn(*head, dsum.data_ptr(), *grads, B, H, L, *strides)
    else:
        groups = attn.clip_groups_for(B, H, L)
        shape = attn.dbias_scratch_shape(H, L, groups)
        parts = None if shape is None else torch.empty(shape, device="cuda")
        d = torch.empty(B, H, L, device="cuda")
        rc = fn(*head, out.data_ptr(), d.data_ptr(), *grads,
                None if parts is None else parts.data_ptr(), B, H, L, groups,
                vector_bytes(bias, mask, gate, stats, d), attn.grid_order_for(H, L),
                *strides)
    if rc != 0:
        raise RuntimeError(f"wavlm_gated_relpos_attention_bwd failed: CUDA error {rc}")
    return dq, dk, dv, dbias, dgate


def sdpa_backward(torch, q, k, v, do):
    """One backward of the maskless bf16 ``scaled_dot_product_attention`` on
    these inputs, its forward run once beforehand: the yardstick for dq, dk
    and dv alone."""
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, scale=1.0)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def profile_split(torch, fn) -> list[tuple[str, float]]:
    """The device time of each kernel of one call of ``fn`` (after a warm
    call), by the profiler: [(kernel name, ms)], longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a process's first trace may come back empty: keep the second
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    split = []
    for evt in prof.key_averages():  # kernels only: not the host ops that launched them
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if (us > 0 and evt.device_type == DeviceType.CUDA
                and evt.key != "Activity Buffer Request"):
            split.append((evt.key, us / 1e3))
    return sorted(split, key=lambda kv: -kv[1])


def print_split(what: str, split) -> None:
    total = sum(ms for _, ms in split)
    print(f"[split] {what}: {len(split)} kernels, {total:.4f} ms of device time", flush=True)
    for name, ms in split:
        print(f"    {ms:9.4f}  {name[:110]}", flush=True)


def time_bwd(torch, attn, prev, runs: int) -> list[dict]:
    """The bf16 backward at its shapes, in turns: through its wrapper and its
    bare C entry, in the other grid order, with one clip group and with
    twice the groups, the earlier checkout's kernel and the library's
    maskless backward; then the kernels' profiler split."""
    from stutter_tpu_torch.ops import _build

    g = torch.Generator(device="cuda").manual_seed(9)
    results = []
    for B, H, L in BWD_TIMED:
        lengths = torch.randint(1, L + 1, (B,), device="cuda", generator=g)
        lengths[0], lengths[-1] = L, 0  # one full clip, one fully padded clip
        args, out, do, stats = bwd_inputs(torch, g, B, H, L, lengths)
        order, groups = attn.grid_order_for(H, L), attn.clip_groups_for(B, H, L)
        fns = {"kernel": lambda: attn.gated_relpos_attention_backward(*args, out, do, stats),
               "bare": lambda: c_bwd_call(torch, _build.kernel_library(), args, out, do, stats),
               "other_order": lambda: attn.launch_backward(*args, out, do, stats, 1 - order,
                                                           groups),
               "groups_1": lambda: attn.launch_backward(*args, out, do, stats, order, 1),
               "groups_x2": lambda: attn.launch_backward(*args, out, do, stats, order,
                                                         min(B, 2 * groups)),
               "library": sdpa_backward(torch, *args[:3], do)}
        if prev is not None:  # its D, computed here once, outside the timed window
            dsum = (do.float() * out.float()).sum(dim=-1).contiguous()
            fns["prev"] = lambda: c_bwd_call(torch, prev, args, out, do, stats, dsum)
        ms = time_turns(torch, list(fns.values()), runs)
        queued = time_turns(torch, list(fns.values()), runs, reps=QUEUED_LAUNCHES)
        n = B * H * L * 64
        # chip_smoke.py's [attn_bwd] bound: five products; q, k, v, do, out, dq,
        # dk, dv in bf16, bias and dbias, gate, the statistics, dgate, mask in f32
        nbytes = 16 * n + 4 * (2 * H * L * L + 4 * B * H * L + B * L)
        bound, bound_by = bound_ms(10 * n * L, nbytes)
        row = {"kernel": "gated_relpos_attention_bwd", "shape": f"{B}x{H}x{L}x64",
               "order": order, "clip_groups": groups, "bound_ms": bound, "bound_by": bound_by}
        for (name, _), t, tq in zip(fns.items(), ms, queued):
            key = "" if name == "kernel" else f"{name}_"
            row[f"{key}ms"], row[f"{key}queued_ms"] = t, tq
        row["queued_share_of_bound"] = bound / row["queued_ms"]
        print(f"[time] {row}", flush=True)
        print_split(f"bwd {B}x{H}x{L}", profile_split(torch, fns["kernel"]))
        results.append(row)
        del args, out, do, stats, fns
        torch.cuda.empty_cache()
    return results


def prev_bwd_splits(torch, prev) -> None:
    """The earlier checkout's backward, one call at each timed shape, by the
    profiler: its kernels and its D reduction in PyTorch."""
    g = torch.Generator(device="cuda").manual_seed(9)
    for B, H, L in BWD_TIMED:
        lengths = torch.randint(1, L + 1, (B,), device="cuda", generator=g)
        lengths[0], lengths[-1] = L, 0
        args, out, do, stats = bwd_inputs(torch, g, B, H, L, lengths)
        print_split(f"prev bwd {B}x{H}x{L} (D in PyTorch)", profile_split(
            torch, lambda: c_bwd_call(torch, prev, args, out, do, stats,
                                      (do.float() * out.float()).sum(dim=-1).contiguous())))


def bound_ms(flops: float, nbytes: float, peak: float = 989e12) -> tuple[float, str]:
    """chip_smoke.py's bound at the bf16 peak (989 TFLOP/s; ``peak``: another
    type's) and 3.35 TB/s."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / 3.35e12 * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def time_gated(torch, attn, prev, runs: int) -> list[dict]:
    """The gated attention at its buckets, in turns: through its wrapper
    and its bare C entry point, in the other grid order, and the earlier
    checkout's kernel."""
    from stutter_tpu_torch.ops import _build

    g = torch.Generator(device="cuda").manual_seed(6)
    results = []
    for B, H, L in GATED_TIMED:
        # a bucket's clips run from the last bucket's length to its own
        lengths = torch.randint(L * 2 // 3, L + 1, (B,), device="cuda", generator=g)
        lengths[0] = L
        args = gated_inputs(torch, g, B, H, L, lengths)
        order = attn.grid_order_for(H, L)
        names = {attn.QUERY_TILE_FASTEST: "query_tile_fastest", attn.CLIP_FASTEST: "clip_fastest"}
        other = 1 - order
        fns = {"kernel": lambda: attn.gated_relpos_attention(*args),
               "bare": lambda: c_gated_call(torch, _build.kernel_library(), *args),
               names[other]: lambda: attn.launch_tiles(*args, None, other)}
        if prev is not None:
            fns["prev"] = lambda: c_gated_call(torch, prev, *args)
        ms = time_turns(torch, list(fns.values()), runs)
        queued = time_turns(torch, list(fns.values()), runs, reps=QUEUED_LAUNCHES)
        n = B * H * L * 64
        bound, bound_by = bound_ms(4 * n * L, 4 * n * 2 + 4 * (H * L * L + B * H * L + B * L))
        row = {"kernel": "gated_relpos_attention", "shape": f"{B}x{H}x{L}x64",
               "order": names[order], "bound_ms": bound, "bound_by": bound_by}
        for (name, _), t, tq in zip(fns.items(), ms, queued):
            key = "" if name == "kernel" else f"{name}_"
            row[f"{key}ms"], row[f"{key}queued_ms"] = t, tq
        row["queued_tflops"] = 4 * n * L / row["queued_ms"] / 1e9
        print(f"[time] {row}", flush=True)
        results.append(row)
        del args
        torch.cuda.empty_cache()
    return results


def time_turns(torch, fns, runs, reps=1):
    """Median ms per launch of each function, in turns: CUDA events around
    ``reps`` launches enqueued back to back (one launch leaves the host's
    time to enqueue it inside the events; several hide it behind the device
    work, as a model's layers do)."""
    for _ in range(3):
        for fn in fns:
            fn()
    times = [[] for _ in fns]
    for _ in range(runs):
        for fn, acc in zip(fns, times):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                fn()
            e1.record()
            e1.synchronize()
            acc.append(e0.elapsed_time(e1) / reps)
    return [sorted(t)[len(t) // 2] for t in times]


def tile_kernels(build) -> list[dict]:
    """ptxas's rows for the bf16 tiles' kernels, each named by its policy and
    its <warpgroups, stages, blocks an SM, grid order>."""
    import re

    rows = build.resource_report("4sm9021attention_bf16_kernel")
    for row in rows:
        m = re.search(r"(\w+?)((?:ELi\d+){4})E", row["kernel"])
        scope, ints = m.group(1), re.findall(r"[0-9]+", m.group(2))
        # the policy is the last <length><name> of its mangled scope
        policy = next(n.group(2) for i in range(len(scope) - 1, -1, -1)
                      if (n := re.fullmatch(r"([0-9]+)([A-Za-z_]\w*)", scope[i:]))
                      and int(n.group(1)) == len(n.group(2)))
        row["tiles"] = f"{policy}<{', '.join(ints)}>"
    return rows


def bwd_tile_kernels(build) -> list[dict]:
    """ptxas's rows for the bf16 backward's wgmma kernels, each named by its
    part and, for dq and dk+dv, its grid order (``dq<0>``, ``dbias``)."""
    import re

    rows = build.resource_report("_bf16_kernel")
    found = []
    for row in rows:
        m = re.search(r"bwd_(dq|dkv|dbias)_bf16_kernel(?:ILi(\d+)EE)?", row["kernel"])
        if m:
            row["tiles"] = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            found.append(row)
    return found


def profile_launches(torch, fn) -> list[tuple[str, float]]:
    """The device time of each kernel launch of one call of ``fn`` (after a
    warm call), by the profiler, in launch order: [(kernel name, ms)]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a process's first trace may come back empty: keep the second
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    launches = [evt for evt in prof.events()
                if evt.device_type == DeviceType.CUDA and evt.name != "Activity Buffer Request"
                and evt.time_range.elapsed_us() > 0]
    launches.sort(key=lambda evt: evt.time_range.start)
    return [(evt.name, evt.time_range.elapsed_us() / 1e3) for evt in launches]


def print_launches(what: str, launches) -> None:
    total = sum(ms for _, ms in launches)
    print(f"[split] {what}: {len(launches)} launches, {total:.4f} ms of device time",
          flush=True)
    for name, ms in launches:
        print(f"    {ms:9.4f}  {name[:110]}", flush=True)


def logmel_wave(torch, g, B):
    """[B, 480000] f32 on the card: noise and a tone per clip."""
    t = torch.arange(480_000, device="cuda") / 16000.0
    f0 = torch.rand(B, 1, device="cuda", generator=g) * 500 + 100
    return 0.1 * torch.randn(B, 480_000, device="cuda", generator=g) + 0.2 * torch.sin(
        2 * torch.pi * f0 * t[None])


def prev_logmel_call(torch, prev, wave, n_mels):
    """An earlier checkout's log-mel as its wrapper ran it: the reflect pad
    in PyTorch, its dense-DFT kernel through its own C signature (x, basis,
    mel, out, B, n_mels, stream) with its [400, 402] basis, then the floor,
    affine and transpose in PyTorch."""
    from stutter_tpu_torch.ops import logmel

    basis, mel_m = logmel._constants(wave.device, n_mels)  # [400, 402] and [201, n_mels]
    x = logmel._reflect_pad(wave).contiguous()
    B = wave.shape[0]
    out = torch.empty((B, 3000, n_mels), dtype=torch.float32, device=wave.device)
    rc = prev.whisper_log_mel(x.data_ptr(), basis.data_ptr(), mel_m.data_ptr(), out.data_ptr(),
                              B, n_mels, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the earlier whisper_log_mel failed: CUDA error {rc}")
    return logmel._floor_affine(out)


def check_logmel(torch, logmel, prev) -> int:
    """The log-mel wrapper against its plain version (and an earlier
    checkout's kernel) at the path's shapes; returns the cases that
    disagree (chip_smoke.py's bar, 1e-4 max-abs)."""
    g = torch.Generator(device="cuda").manual_seed(11)
    failures = 0
    for B, n_mels in LOGMEL_TIMED:
        wave = logmel_wave(torch, g, B)
        out = logmel.whisper_log_mel(wave, n_mels)
        ref = logmel.log_mel_spectrogram_reference(wave, n_mels)
        err = float((out - ref).abs().max())
        line = f"[check] logmel {B}x480000 n_mels={n_mels} max_abs={err:.3e}"
        if prev is not None:
            prev_err = (prev_logmel_call(torch, prev, wave, n_mels) - ref).abs().max()
            line += f" prev_max_abs={float(prev_err):.3e}"
        ok = err <= LOGMEL_MAX_ABS and bool(torch.isfinite(out).all())
        print(f"{line} {'ok' if ok else 'DISAGREES'}", flush=True)
        failures += not ok
    # How far the kernel and the plain f32 version each lie from the float64
    # log-mel on a tone under which f32 time stamps put phase noise ~60 dB
    # down: a report, not a check.
    t = torch.arange(480_000, device="cuda") / 16000.0
    tone = (0.5 * torch.sin(2 * torch.pi * 440.0 * t))[None]
    for n_mels in (80, 128):
        exact = logmel.log_mel_spectrogram_reference(tone.double(), n_mels)
        kernel = float((logmel.whisper_log_mel(tone, n_mels).double() - exact).abs().max())
        plain = float((logmel.log_mel_spectrogram_reference(tone, n_mels).double()
                       - exact).abs().max())
        print(f"[accuracy] f32-stamped tone n_mels={n_mels} kernel_vs_float64={kernel:.3e} "
              f"plain_vs_float64={plain:.3e}", flush=True)
    return failures


def time_logmel(torch, logmel, prev, runs: int) -> list[dict]:
    """The log-mel at its path shapes: the profiler's split of one call
    (reflect pad, kernel, epilogue ops) of the earlier checkout's and of
    this one's, then per launch and queued in turns with the earlier
    kernel and the plain version."""
    g = torch.Generator(device="cuda").manual_seed(12)
    results = []
    for B, n_mels in LOGMEL_TIMED:
        wave = logmel_wave(torch, g, B)
        fns = {"kernel": lambda: logmel.whisper_log_mel(wave, n_mels),
               "plain": lambda: logmel.log_mel_spectrogram_reference(wave, n_mels)}
        if prev is not None:
            fns["prev"] = lambda: prev_logmel_call(torch, prev, wave, n_mels)
            print_launches(f"prev logmel {B}x480000 n_mels={n_mels}",
                           profile_launches(torch, fns["prev"]))
        print_launches(f"logmel {B}x480000 n_mels={n_mels}",
                       profile_launches(torch, fns["kernel"]))
        if runs == 0:
            continue
        ms = time_turns(torch, list(fns.values()), runs)
        queued = time_turns(torch, list(fns.values()), runs, reps=QUEUED_LAUNCHES)
        row = {"kernel": "whisper_log_mel", "shape": f"{B}x480000", "n_mels": n_mels}
        for (name, _), t, tq in zip(fns.items(), ms, queued):
            key = "" if name == "kernel" else f"{name}_"
            row[f"{key}ms"], row[f"{key}queued_ms"] = t, tq
        print(f"[time] {row}", flush=True)
        results.append(row)
    return results


def seeded_stem_layers(torch):
    """WavLM-Large's conv stem in bf16 on the card: weights drawn like
    init_wavlm's, biases and norm affines given seeded noise so that every
    term of the epilogue is exercised."""
    from stutter_tpu_torch.models.wavlm import ConvFeatureEncoder, WavLMConfig

    g = torch.Generator().manual_seed(0)
    stem = ConvFeatureEncoder(WavLMConfig.large())
    with torch.no_grad():
        for layer in stem.layers:
            c_out, c_in, k = layer.weight.shape
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=g) * (c_in * k) ** -0.5)
            layer.bias.copy_(torch.randn(c_out, generator=g) * 0.1)
            layer.norm_scale.copy_(1.0 + 0.1 * torch.randn(c_out, generator=g))
            layer.norm_bias.copy_(0.1 * torch.randn(c_out, generator=g))
    return stem.to("cuda", torch.bfloat16)


def prev_stem_pack(torch, conv_layers):
    """The stem weights as the 64-row mma.sync stem kernel took them: each
    layer's tap-major [k * C_in, 512] matrix stacked, layer 0's 10 rows
    zero-padded to 16; and the [7, 3, 512] f32 table."""
    mats, rows = [], []
    for i, layer in enumerate(conv_layers):
        w = layer.weight.detach()
        C, c_in, k = w.shape
        mat = w.permute(2, 1, 0).reshape(k * c_in, C).to(torch.bfloat16)
        if i == 0:
            mat = torch.cat([mat, mat.new_zeros(16 - mat.shape[0], C)])
        mats.append(mat)
        rows.append(torch.stack([layer.bias.detach().float(), layer.norm_scale.detach().float(),
                                 layer.norm_bias.detach().float()]))
    return torch.cat(mats).contiguous(), torch.stack(rows).contiguous()


def prev_stem_call(torch, prev, wave, weights, table):
    """An earlier checkout's stem through its own C signature (wave,
    weights, table, buf0, buf1, out, B, T, stream) and packing."""
    from stutter_tpu_torch.ops.wavlm_stem import stem_layer_lengths

    B, T = wave.shape
    lengths = stem_layer_lengths(T)
    opts = dict(dtype=torch.bfloat16, device=wave.device)
    buf0 = torch.empty((B, lengths[0], 512), **opts)
    buf1 = torch.empty((B, lengths[1], 512), **opts)
    out = torch.empty((B, lengths[-1], 512), **opts)
    rc = prev.wavlm_fused_stem(wave.data_ptr(), weights.data_ptr(), table.data_ptr(),
                               buf0.data_ptr(), buf1.data_ptr(), out.data_ptr(), B, T,
                               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the earlier wavlm_fused_stem failed: CUDA error {rc}")
    return out


def stem_close(torch, out, ref) -> tuple[bool, float, float]:
    d = out.float() - ref.float()
    nrmse = float(d.norm() / ref.float().norm())
    cos = cosine_distance(out.float(), ref.float())
    ok = bool(torch.isfinite(out).all()) and nrmse <= STEM_NRMSE and cos <= STEM_COSINE
    return ok, nrmse, cos


def layer1_gemm_ms(torch, B: int, T: int, runs: int) -> float:
    """A yardstick for the tensor cores' share: cuBLAS's bf16 product of the
    stem's layer 1 as a GEMM alone ([B T_1, 3 x 512] im2col rows, made
    here, by the [1536, 512] weight), 8 queued, ms a product."""
    from stutter_tpu_torch.ops.wavlm_stem import stem_layer_lengths

    rows = B * stem_layer_lengths(T)[1]
    a = torch.randn(rows, 3 * 512, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(3 * 512, 512, device="cuda", dtype=torch.bfloat16)
    ms, = time_turns(torch, [lambda: a @ w], runs, reps=QUEUED_LAUNCHES)
    del a, w
    torch.cuda.empty_cache()
    return ms


def time_stem(torch, prev, runs: int) -> list[dict]:
    """The fused stem at its buckets: each checked against its plain
    version, the profiler's split of one call by layer (the earlier
    checkout's and this one's), then per launch and queued in turns with
    the earlier kernel."""
    from stutter_tpu_torch.ops import wavlm_stem as st

    stem = seeded_stem_layers(torch)
    weights, table = stem.packed()
    prev_packed = prev_stem_pack(torch, stem.layers) if prev is not None else None
    g = torch.Generator(device="cuda").manual_seed(13)
    results = []
    for B, T in STEM_TIMED:
        wave = torch.randn(B, T, device="cuda", generator=g) * 0.5
        fns = {"kernel": lambda: st.wavlm_fused_stem(wave, weights, table)}
        if prev is not None:
            fns["prev"] = lambda: prev_stem_call(torch, prev, wave, *prev_packed)
        ref = st.wavlm_fused_stem_reference(wave, weights, table)
        for name, fn in fns.items():
            ok, nrmse, cos = stem_close(torch, fn(), ref)
            print(f"[check] stem {name} {B}x{T} nrmse={nrmse:.3e} cosine={cos:.3e} "
                  f"{'ok' if ok else 'DISAGREES'}", flush=True)
            if not ok:
                raise RuntimeError(f"the stem ({name}) disagrees with its plain version")
        del ref
        for name, fn in reversed(fns.items()):
            print_launches(f"{name} stem {B}x{T}", profile_launches(torch, fn))
        if runs == 0:
            continue
        ms = time_turns(torch, list(fns.values()), runs)
        queued = time_turns(torch, list(fns.values()), runs, reps=QUEUED_LAUNCHES)
        row = {"kernel": "wavlm_fused_stem", "shape": f"{B}x{T}"}
        for (name, _), t, tq in zip(fns.items(), ms, queued):
            key = "" if name == "kernel" else f"{name}_"
            row[f"{key}ms"], row[f"{key}queued_ms"] = t, tq
        row["layer1_gemm_cublas_queued_ms"] = layer1_gemm_ms(torch, B, T, runs)
        print(f"[time] {row}", flush=True)
        results.append(row)
        torch.cuda.empty_cache()
    return results


def stem_tile_kernels(build) -> list[dict]:
    """ptxas's rows for the stem's wgmma conv kernels, each named by its taps
    (``conv<3>``, ``conv<2>``)."""
    import re

    found = []
    for row in build.resource_report("stem_conv_kernel"):
        m = re.search(r"stem_conv_kernelILi(\d+)EE", row["kernel"])
        if m:
            row["tiles"] = f"conv<{m.group(1)}>"
            found.append(row)
    return found



def probe_inputs(torch, g, B, L):
    """The probes' operands on the card: contiguous bf16 q, k, v (randn *
    0.3), bias, gate, and a key mask that cuts the last clip short."""
    H = 16
    q, k, v = ((torch.randn(B, H, L, 64, device="cuda", generator=g) * 0.3).to(torch.bfloat16)
               for _ in range(3))
    bias = torch.randn(H, L, L, device="cuda", generator=g)
    gate = torch.rand(B, H, L, device="cuda", generator=g)
    mask = torch.zeros(B, L, device="cuda")
    mask[-1, L // 2:] = -1e9
    return q, k, v, bias, gate, mask


def int8_operands_equal(torch, probes, k, v) -> bool:
    """Whether the int8 prologue's k and v and their scales equal the plain
    version's bit for bit, vq in its padded transposed layout."""
    kq, sk, vqt, sv = probes.quantize_kv(k, v)
    rkq, rsk, rvq, rsv = probes.quantize_kv_reference(k, v)
    return (torch.equal(kq, rkq) and torch.equal(sk, rsk) and torch.equal(sv, rsv)
            and torch.equal(vqt, probes.transpose_padded_reference(rvq)))


def check_probe_cases(torch, probes, cases, verbose: bool = True) -> tuple[int, int]:
    """The int8 probe (its int8 operands bit-equal to the plain version's)
    and the four softmax variants against their plain versions at each
    (clips, frames) of ``cases``: (cases run, cases that disagree)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    n = bad = 0
    for B, L in cases:
        args = probe_inputs(torch, g, B, L)
        operands_equal = int8_operands_equal(torch, probes, args[1], args[2])
        runs = [("int8", lambda: probes.int8_attention_long(*args),
                 lambda: probes.int8_attention_long_reference(*args),
                 PROBE_INT8_MAX_ABS, PROBE_INT8_COSINE)]
        for name, (pn, chain) in probes.VARIANTS.items():
            runs.append((name,
                         lambda pn=pn, c=chain: probes.softmax_variant_attention(*args, pn, c),
                         lambda pn=pn, c=chain: probes.softmax_variant_attention_reference(
                             *args, pn, c),
                         PROBE_VARIANT_MAX_ABS, PROBE_VARIANT_COSINE[name]))
        for name, fn, plain, tol_abs, tol_cos in runs:
            out, ref = fn().float(), plain().float()
            max_abs = float((out - ref).abs().max())
            cos = cosine_distance(out, ref)
            ok = (bool(torch.isfinite(out).all()) and max_abs <= tol_abs and cos <= tol_cos
                  and (operands_equal or name != "int8"))
            n += 1
            bad += not ok
            if verbose or not ok:
                extra = f" int8_operands_equal={operands_equal}" if name == "int8" else ""
                print(f"[check] probe {name} {B}x16x{L}: max_abs={max_abs:.3e} (tol {tol_abs}) "
                      f"cosine={cos:.3e} (tol {tol_cos}){extra}{'' if ok else '  FAILED'}",
                      flush=True)
            if not ok:
                print(error_map(torch, out, ref), flush=True)
            del out, ref
        del args, runs
        torch.cuda.empty_cache()
    return n, bad


def prev_key_align(root: Path) -> int:
    """The earlier checkout's int8 key padding (its ops/attn_probes.py's
    KEY_ALIGN: 32 before the probes took the wgmma tiles, 64 since), which
    its attn_int8 entries expect of Lp."""
    import re

    text = (root / "stutter_tpu_torch" / "ops" / "attn_probes.py").read_text()
    return int(re.search(r"^KEY_ALIGN = (\d+)", text, re.M).group(1))


def int8_buffers(torch, q, align: int) -> tuple:
    """The int8 prologue's outputs for q's shape, Lp a multiple of ``align``,
    and the output."""
    B, H, L, d = q.shape
    Lp = -(-L // align) * align
    dev = q.device
    return (torch.empty((B, H, L, d), dtype=torch.int8, device=dev),
            torch.empty((B, H, L), device=dev),
            torch.empty((B, H, d, Lp), dtype=torch.int8, device=dev),
            torch.empty((B, H, d), device=dev), torch.empty_like(q))


def c_int8_call(torch, lib, bufs, q, k, v, bias, gate, mask):
    """A kernel library's int8 probe through its two bare C entries."""
    kq, sk, vqt, sv, out = bufs
    B, H, L, _ = q.shape
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.attn_int8_quantize_kv(k.data_ptr(), v.data_ptr(), kq.data_ptr(), sk.data_ptr(),
                                   vqt.data_ptr(), sv.data_ptr(), B * H, L, vqt.shape[-1], stream)
    if rc == 0:
        rc = lib.attn_int8(q.data_ptr(), kq.data_ptr(), sk.data_ptr(), vqt.data_ptr(),
                           sv.data_ptr(), bias.data_ptr(), gate.data_ptr(), mask.data_ptr(),
                           out.data_ptr(), B, H, L, vqt.shape[-1], stream)
    if rc != 0:
        raise RuntimeError(f"attn_int8 failed: CUDA error {rc}")
    return out


def c_variant_call(torch, lib, out, q, k, v, bias, gate, mask, postnorm, chain):
    """A kernel library's softmax variant through its bare C entry."""
    B, H, L, _ = q.shape
    rc = lib.attn_softmax_variant(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                  gate.data_ptr(), mask.data_ptr(), out.data_ptr(), B, H, L,
                                  int(postnorm), int(chain),
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"attn_softmax_variant failed: CUDA error {rc}")
    return out


def time_probes(torch, probes, attn, prev, prev_align, runs: int) -> list[dict]:
    """The probes at their two cases, in turns: each kernel through its
    wrapper and its bare C entry, the earlier checkout's kernel, and the
    incumbent gated attention."""
    from stutter_tpu_torch.ops import _build

    g = torch.Generator(device="cuda").manual_seed(14)
    lib = _build.kernel_library()
    results = []
    for B, L in PROBE_TIMED:
        args = probe_inputs(torch, g, B, L)
        bufs = int8_buffers(torch, args[0], probes.KEY_ALIGN)
        fns = {"int8": lambda: probes.int8_attention_long(*args),
               "int8_bare": lambda: c_int8_call(torch, lib, bufs, *args)}
        if prev is not None:
            prev_bufs = int8_buffers(torch, args[0], prev_align)
            fns["int8_prev"] = lambda: c_int8_call(torch, prev, prev_bufs, *args)
        out = torch.empty_like(args[0])
        for name, (pn, chain) in probes.VARIANTS.items():
            fns[name] = lambda pn=pn, c=chain: probes.softmax_variant_attention(*args, pn, c)
            fns[f"{name}_bare"] = lambda pn=pn, c=chain: c_variant_call(
                torch, lib, out, *args, pn, c)
            if prev is not None:
                fns[f"{name}_prev"] = lambda pn=pn, c=chain: c_variant_call(
                    torch, prev, out, *args, pn, c)
        fns["incumbent"] = lambda: attn.gated_relpos_attention(*args)
        ms = dict(zip(fns, time_turns(torch, list(fns.values()), runs)))
        queued = dict(zip(fns, time_turns(torch, list(fns.values()), runs, reps=QUEUED_LAUNCHES)))
        n = B * 16 * L * 64
        nbytes = 4 * n * 2 + 4 * (16 * L * L + B * 16 * L + B * L)
        for name in ["int8", *probes.VARIANTS, "incumbent"]:
            bound, bound_by = bound_ms(4 * n * L, nbytes, 1979e12 if name == "int8" else 989e12)
            row = {"kernel": name, "shape": f"{B}x16x{L}x64", "bound_ms": bound,
                   "bound_by": bound_by}
            for suffix in ("", "_bare", "_prev"):
                if name + suffix in fns:
                    key = suffix[1:] + "_" if suffix else ""
                    row[f"{key}ms"], row[f"{key}queued_ms"] = ms[name + suffix], queued[name + suffix]
            row["share_of_bound"] = bound / row["queued_ms"]
            row["vs_incumbent_queued"] = row["queued_ms"] / queued["incumbent"]
            if "prev_queued_ms" in row:
                row["speedup_vs_prev_queued"] = row["prev_queued_ms"] / row["queued_ms"]
            print(f"[time] {row}", flush=True)
            results.append(row)
        del args, bufs, fns, out
        torch.cuda.empty_cache()
    return results


def probe_kernel_rows(build) -> list[dict]:
    """ptxas's rows for the probes' kernels, named ``quantize_kv``,
    ``attn_int8`` and ``softmax_variant<postnorm, bf16chain>``."""
    import re

    found = []
    for pattern in ("quantize_kv_kernel", "attn_int8_kernel", "softmax_variant_kernel"):
        for row in build.resource_report(pattern):
            m = re.search(r"softmax_variant_kernelILb(\d)ELb(\d)EE", row["kernel"])
            row["tiles"] = (f"softmax_variant<{m.group(1)}, {m.group(2)}>" if m
                            else pattern.removesuffix("_kernel"))
            found.append(row)
    return found


def sass_functions(lib_path: Path) -> dict[str, list[tuple[int, str]]]:
    """The SASS of every kernel of a built library (``cuobjdump -sass``):
    {mangled name: [(address, instruction text)]}, branch targets written as
    addresses."""
    import re

    from stutter_tpu_torch.ops._build import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name, labels, pending = m.group(1), {}, []
            funcs[name] = []
            continue
        if name is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[label] = addr
            pending = []
            funcs[name].append((addr, m.group(2)))
    for name, instrs in funcs.items():  # labels -> addresses
        funcs[name] = [(a, re.sub(r"`?\(?(\.L_x_\d+)\)?", lambda m: hex(labels.get(m.group(1), -1)),
                                  s)) for a, s in instrs]
    return funcs


def opcode(text: str) -> str:
    """An instruction's opcode without its predicate: MUFU keeps its
    function (MUFU.EX2), the others lose their modifiers."""
    op = text.split()[1] if text.startswith("@") else text.split()[0]
    return op if op.startswith("MUFU") else op.split(".")[0]


def sass_loops(instrs: list[tuple[int, str]]) -> list[dict]:
    """The loops of one kernel that issue wgmma, in program order, with the
    opcodes their body always runs: the instructions between a loop's head
    and its backward branch that no forward branch inside the body jumps
    over (the edge tile's masking, a rescale, the 4-byte copies are skipped
    on the common path). ``tiles``: key tiles an iteration (MUFU.EX2 / 32,
    one exponential a score and 32 scores a thread and tile)."""
    import re

    index = {a: i for i, (a, _) in enumerate(instrs)}
    branches = []
    for i, (a, text) in enumerate(instrs):
        m = re.search(r"\bBRA\S*\s+(?:[^,;]*,\s*)?(0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) in index:
            branches.append((i, index[int(m.group(1), 16)]))
    loops = []
    last = {}  # a loop's head -> its last backward branch
    for i, head in branches:
        if head < i:
            last[head] = max(i, last.get(head, i))
    for head, i in last.items():
        body = range(head, i + 1)
        if not any("GMMA" in opcode(instrs[j][1]) for j in body):
            continue
        skipped = set()
        for a, target in branches:
            if head <= a < target <= i:
                skipped.update(range(a + 1, target))
        counts = {}
        for j in body:
            if j not in skipped:
                op = opcode(instrs[j][1])
                counts[op] = counts.get(op, 0) + 1
        loops.append({"head": instrs[head][0], "counts": counts,
                      "tiles": max(1, round(counts.get("MUFU.EX2", 0) / 32))})
    return sorted(loops, key=lambda loop: loop["head"])


# the opcodes of a score's chain, shown per score
CHAIN_OPS = ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "MUFU.EX2", "F2FP", "HFMA2", "HADD2",
             "HMUL2", "HMNMX2", "PRMT", "IADD3", "LOP3", "I2F", "F2I", "LDS", "SHFL")


def probe_sass(lib_path: Path) -> list[dict]:
    """Per probe kernel: its wgmma and mma.sync opcodes, and per wgmma loop
    (a pass) the chain's opcodes per score and all instructions per score."""
    import re

    rows = []
    for name, instrs in sass_functions(lib_path).items():
        m = re.search(r"softmax_variant_kernelILb(\d)ELb(\d)EE", name)
        kernel = (f"softmax_variant<{m.group(1)}, {m.group(2)}>" if m else
                  "attn_int8" if "attn_int8_kernel" in name else None)
        if kernel is None:
            continue
        ops = [opcode(text) for _, text in instrs]
        row = {"kernel": kernel, **{op: ops.count(op) for op in ("HGMMA", "IGMMA", "HMMA", "IMMA")},
               "passes": []}
        for loop in sass_loops(instrs):
            per = 32 * loop["tiles"]
            row["passes"].append({
                "tiles_an_iteration": loop["tiles"],
                "per_score": {op: round(loop["counts"].get(op, 0) / per, 3) for op in CHAIN_OPS
                              if loop["counts"].get(op)},
                "all_per_score": round(sum(loop["counts"].values()) / per, 3)})
        rows.append(row)
    return sorted(rows, key=lambda row: row["kernel"])


def probes_main(torch, card: str, prev_root, runs: int) -> int:
    """--kernels probes: ptxas rows, SASS, checks, times; the JSON line."""
    from stutter_tpu_torch.ops import _build
    from stutter_tpu_torch.ops import attn_probes as probes
    from stutter_tpu_torch.ops import wavlm_attention as attn

    for row in probe_kernel_rows(_build):
        print(f"[ptxas] probe {row['tiles']} registers={row['registers']} "
              f"stack={row['stack_bytes']} spill_stores={row['spill_store_bytes']} "
              f"spill_loads={row['spill_load_bytes']}", flush=True)
    sass = probe_sass(_build.library_path())
    for row in sass:
        print(f"[sass] {json.dumps(row)}", flush=True)
    cases, bad = check_probe_cases(torch, probes, PROBE_TIMED + PROBE_EDGES)
    print(f"[check] probes: {bad} of {cases} cases disagree", flush=True)
    if bad:
        return 1
    results = []
    if runs:
        prev = prev_align = None
        if prev_root:
            prev, prev_align = load_prev_library(Path(prev_root)), prev_key_align(Path(prev_root))
        results = time_probes(torch, probes, attn, prev, prev_align, runs)
    print(json.dumps({"card": card, "sass": sass, "times": results}))
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch
    import torch.nn.functional as F

    from stutter_tpu_torch.extract.pipeline import resolve_device
    from stutter_tpu_torch.ops import _build
    from stutter_tpu_torch.ops import flash_mha as mha
    from stutter_tpu_torch.ops import logmel
    from stutter_tpu_torch.ops import wavlm_attention as attn

    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"[device] {card}", flush=True)

    _build.kernel_library()
    for row in tile_kernels(_build):
        print(f"[ptxas] {row['tiles']} registers={row['registers']} "
              f"stack={row['stack_bytes']} spill_stores={row['spill_store_bytes']} "
              f"spill_loads={row['spill_load_bytes']}", flush=True)
    for row in bwd_tile_kernels(_build):
        print(f"[ptxas] bwd {row['tiles']} registers={row['registers']} "
              f"stack={row['stack_bytes']} spill_stores={row['spill_store_bytes']} "
              f"spill_loads={row['spill_load_bytes']}", flush=True)
    for row in stem_tile_kernels(_build):
        print(f"[ptxas] stem {row['tiles']} registers={row['registers']} "
              f"stack={row['stack_bytes']} spill_stores={row['spill_store_bytes']} "
              f"spill_loads={row['spill_load_bytes']}", flush=True)
    warnings = _build.serialized_wgmma_warnings()
    print(f"[ptxas] serialized_wgmma_warnings={len(warnings)}", flush=True)
    for line in warnings[:8]:
        print(f"    {line}", flush=True)

    if args.kernels == "probes":
        return probes_main(torch, card, args.prev_root, 0 if args.skip_timing else args.runs)
    bwd = args.kernels in ("all", "bwd")
    own = args.kernels in ("logmel", "stem")  # timed with their earlier kernels alone
    prev = None
    if args.prev_root and (bwd or own or not args.skip_timing):
        prev = load_prev_library(Path(args.prev_root))
    failures = 0
    if args.kernels in ("all", "flash"):
        cases, bad, _ = check_cases(torch, mha)
        print(f"[check] flash: {bad} of {cases} cases disagree", flush=True)
        failures += bad
    if args.kernels in ("all", "gated"):
        cases, bad, _, _ = check_gated_cases(torch, attn)
        print(f"[check] gated: {bad} of {cases} cases disagree", flush=True)
        failures += bad
    if args.kernels in ("all", "bwd"):
        cases, bad, _ = check_bwd_cases(torch, attn)
        print(f"[check] bwd: {bad} of {cases} cases disagree", flush=True)
        failures += bad
    if args.kernels == "logmel":
        failures += check_logmel(torch, logmel, prev)
    if failures:
        return 1
    if own:
        runs = 0 if args.skip_timing else args.runs
        results = (time_logmel(torch, logmel, prev, runs) if args.kernels == "logmel"
                   else time_stem(torch, prev, runs))
        print(json.dumps({"card": card, "times": results}))
        return 0
    if prev is not None and bwd:
        prev_bwd_splits(torch, prev)
    if args.skip_timing:
        return 0

    g = torch.Generator(device="cuda").manual_seed(5)
    results = []
    for name, B, H, L in TIMED if args.kernels in ("all", "flash") else []:
        q, k, v = make_qkv(torch, g, B, H, L)
        if name == "flash_mha":
            extra, mask = None, None
            new = lambda: mha.flash_mha(q, k, v)  # noqa: E731
        else:
            extra = torch.randn(B, H, L, L, device="cuda", generator=g)
            mask = extra.bfloat16()  # the library call takes the mask in q's type
            new = lambda: mha.flash_mha_bias(q, k, v, extra)  # noqa: E731
        fns = [new, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0),
               lambda: c_call(torch, _build.kernel_library(), name, q, k, v, extra)]
        if prev is not None:
            fns.append(lambda: c_call(torch, prev, name, q, k, v, extra))
        ms = time_turns(torch, fns, args.runs)
        queued = time_turns(torch, fns, args.runs, reps=QUEUED_LAUNCHES)
        row = {"kernel": name, "shape": f"{B}x{H}x{L}x64", "ms": ms[0], "library_ms": ms[1],
               "queued_ms": queued[0], "library_queued_ms": queued[1],
               "bare_ms": ms[2], "bare_queued_ms": queued[2],
               "queued_tflops": 4 * B * H * L * L * 64 / queued[0] / 1e9}
        if prev is not None:
            row["prev_ms"], row["prev_queued_ms"] = ms[3], queued[3]
        if extra is not None:
            row["queued_ab_tb_per_s"] = 4 * extra.numel() / queued[0] / 1e9
        print(f"[time] {row}", flush=True)
        results.append(row)
        del q, k, v, extra, mask
        torch.cuda.empty_cache()
    if args.kernels in ("all", "gated"):
        results += time_gated(torch, attn, prev, args.runs)
    if bwd:
        results += time_bwd(torch, attn, prev, args.runs)
    print(json.dumps({"card": card, "times": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
