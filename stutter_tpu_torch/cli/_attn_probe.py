"""What the two attention-probe CLIs share (``cli/attn_int8_probe.py`` and
``cli/attn_softmax_variants_probe.py``): their flags, their inputs, the f32
reference on a 2-clip slice, the cosine distance, the timing rounds and the
output."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np

H, HEAD_DIM = 16, 64
REF_CLIPS = 2  # the f32 reference runs on the first clips only, as in the probes


def parse_args(description: str, argv=None):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--cases", type=str, default="1008,30;1504,25",
                        help="'L,B;L,B': frames and clips of each case")
    parser.add_argument("--iters", type=int, default=8, help="calls per timing")
    parser.add_argument("--loops", type=int, default=3, help="timing rounds")
    parser.add_argument("--out", type=str, default=None, help="also write the JSON here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device to run on (default: cuda)")
    return parser.parse_args(argv)


def cases(spec: str) -> list[tuple[int, int]]:
    """'L,B;L,B' -> [(L, B), ...]."""
    return [tuple(int(x) for x in case.split(",")) for case in spec.split(";")]


def probe_inputs(torch, B: int, L: int, device):
    """The probes' inputs, from RandomState(0) in their order: q, k, v
    (randn * 0.3, bf16, [B, 16, L, 64]), bias randn [16, L, L], gate rand
    [B, 16, L] and a zero mask [B, L], all on ``device``."""
    rs = np.random.RandomState(0)

    def mk(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32) * 0.3).to(
            device=device, dtype=torch.bfloat16)

    q, k, v = mk(B, H, L, HEAD_DIM), mk(B, H, L, HEAD_DIM), mk(B, H, L, HEAD_DIM)
    bias = torch.from_numpy(rs.randn(H, L, L).astype(np.float32)).to(device)
    gate = torch.from_numpy(rs.rand(B, H, L).astype(np.float32)).to(device)
    mask = torch.zeros((B, L), dtype=torch.float32, device=device)
    return q, k, v, bias, gate, mask


def f32_reference(torch, q, k, v, bias, gate, mask):
    """The probes' f32 reference on the first REF_CLIPS clips, [2, 16, L, 64] f32."""
    from stutter_tpu_torch.ops.precision import no_tf32

    n = REF_CLIPS
    with no_tf32():
        s = torch.matmul(q[:n].float(), k[:n].float().transpose(-1, -2))
        p = s + gate[:n, ..., None] * bias[None] + mask[:n, None, None, :]
        return torch.matmul(torch.softmax(p, dim=-1), v[:n].float())


def cosine_distance(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(1.0 - (a @ b) / (a.norm() * b.norm()))


def time_rounds(torch, fns: dict, iters: int, loops: int, device) -> dict:
    """ms per call of each function: after one warm call each, ``loops``
    rounds that take the functions in turn, ``iters`` calls a timing; CUDA
    events on the card, the host clock on the CPU."""
    for fn in fns.values():
        fn()
    ms = {name: [] for name in fns}
    cuda = device.type == "cuda"
    for _ in range(loops):
        for name, fn in fns.items():
            if cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(device)
                e0.record()
                for _ in range(iters):
                    fn()
                e1.record()
                e1.synchronize()
                ms[name].append(e0.elapsed_time(e1) / iters)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                ms[name].append((time.perf_counter() - t0) * 1e3 / iters)
    return ms


def device_fields(torch, device) -> dict:
    """The device a result ran on: the card's name and power limit as
    nvidia-smi gives them, or the CPU."""
    if device.type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    return {"device": torch.cuda.get_device_name(device), "card": card}


def emit(out: dict, path: str | None) -> None:
    """The whole result as the last line of stdout, and into ``path``."""
    print(json.dumps(out), flush=True)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
