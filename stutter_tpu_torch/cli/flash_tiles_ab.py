"""Check and time the bf16 flash-attention tiles on a CUDA card, beside an
earlier checkout's kernel and ``scaled_dot_product_attention``.

    python -m stutter_tpu_torch.cli.flash_tiles_ab [--prev_root DIR] [--runs 20] \\
        [--skip_timing]

1. Prints what ``ptxas -v`` said of the bf16 kernels at the build
   (registers, spills, stack) and any "wgmma serialized" warning.
2. Holds ``flash_mha`` and ``flash_mha_bias`` (bf16) against their plain
   versions over ragged lengths and key counts; a case that disagrees prints
   a map of its errors by 16-row and 8-column block and the run fails.
3. Times, with CUDA events and in turns, the kernel, the kernel of the
   checkout at ``--prev_root`` (the same C entry points, built from that
   checkout's sources into its own build directory) and the library call,
   at the Whisper encoder's shape and the two long WavLM buckets: per
   launch (``ms``, as ``chip_smoke.py`` times every kernel; the host's time
   to enqueue the launch lies inside the events) and per launch of 8
   enqueued back to back (``queued_ms``: the device's time alone).
   ``--prev_root`` is a directory holding an earlier commit of this
   repository, e.g. ``git archive <commit> | tar -x -C <dir>``.

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
QUEUED_LAUNCHES = 8  # launches between two events in the second timing
TIMED = [("flash_mha", 16, 20, 1500), ("flash_mha_bias", 12, 16, 1504),
         ("flash_mha_bias", 19, 16, 1008)]


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--prev_root", default=None)
    parser.add_argument("--runs", type=int, default=20)
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


def prev_call(torch, lib, name, q, k, v, extra):
    """Launch the earlier checkout's entry point (its signature: no ab_vec)."""
    out = torch.empty_like(q)
    B, H, L, _ = q.shape
    rc = getattr(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            None if extra is None else extra.data_ptr(), out.data_ptr(),
                            B, H, L, q.stride(0), q.stride(1), q.stride(2), 1,
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier {name} failed: CUDA error {rc}")
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


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch
    import torch.nn.functional as F

    from stutter_tpu_torch.extract.pipeline import resolve_device
    from stutter_tpu_torch.ops import _build
    from stutter_tpu_torch.ops import flash_mha as mha

    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"[device] {card}", flush=True)

    _build.kernel_library()
    for row in _build.resource_report("4sm9021attention_bf16_kernel"):
        print(f"[ptxas] {row}", flush=True)
    warnings = _build.serialized_wgmma_warnings()
    print(f"[ptxas] serialized_wgmma_warnings={len(warnings)}", flush=True)
    for line in warnings[:8]:
        print(f"    {line}", flush=True)

    cases, failures, _ = check_cases(torch, mha)
    if failures:
        print(f"[check] {failures} of {cases} cases disagree", flush=True)
        return 1
    if args.skip_timing:
        return 0

    prev = load_prev_library(Path(args.prev_root)) if args.prev_root else None
    g = torch.Generator(device="cuda").manual_seed(5)
    results = []
    for name, B, H, L in TIMED:
        q, k, v = make_qkv(torch, g, B, H, L)
        if name == "flash_mha":
            extra, mask = None, None
            new = lambda: mha.flash_mha(q, k, v)  # noqa: E731
        else:
            extra = torch.randn(B, H, L, L, device="cuda", generator=g)
            mask = extra.bfloat16()  # the library call takes the mask in q's type
            new = lambda: mha.flash_mha_bias(q, k, v, extra)  # noqa: E731
        fns = [new, lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)]
        if prev is not None:
            fns.append(lambda: prev_call(torch, prev, name, q, k, v, extra))
        ms = time_turns(torch, fns, args.runs)
        queued = time_turns(torch, fns, args.runs, reps=QUEUED_LAUNCHES)
        row = {"kernel": name, "shape": f"{B}x{H}x{L}x64", "ms": ms[0], "library_ms": ms[1],
               "queued_ms": queued[0], "library_queued_ms": queued[1],
               "queued_tflops": 4 * B * H * L * L * 64 / queued[0] / 1e9}
        if prev is not None:
            row["prev_ms"], row["prev_queued_ms"] = ms[2], queued[2]
        if extra is not None:
            row["queued_ab_tb_per_s"] = 4 * extra.numel() / queued[0] / 1e9
        print(f"[time] {row}", flush=True)
        results.append(row)
        del q, k, v, extra, mask
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "times": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
