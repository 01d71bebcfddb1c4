"""Host ``load_audio`` of one long file, one tree of the port against another.

The chunk long-file policy (``stutter_tpu_torch.extract.pipeline``) loads
each long file whole through ``stutter_tpu_torch.audio.wavio.load_audio``,
which resamples it to 16 kHz on the host. This times that call on a long
mono 16-bit WAV at 44.1 kHz (resampled) and at 16 kHz (not resampled) for
each tree given. Each tree runs in a process of its own with the tree first
on ``PYTHONPATH``, in the order given: give parent, change, change, parent
to compare two commits. One line per run: the median and the spread of 5
calls after one warm-up call (which builds the host library where the tree
has one), and the largest difference of the 44.1 kHz output from the first
run's.

    python3 scripts/torch_load_audio_ab.py --tree PARENT --tree . --tree . --tree PARENT
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

CHILD = r"""
import json, statistics, sys, time
import numpy as np, torch
from stutter_tpu_torch.audio.wavio import load_audio
out = {"torch_threads": torch.get_num_threads()}
for name, path in json.loads(sys.argv[1]).items():
    load_audio(path)
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        y = load_audio(path)
        ms.append((time.perf_counter() - t0) * 1e3)
    out[name] = {"median_ms": statistics.median(ms), "ms": ms, "samples": int(len(y))}
    np.save(sys.argv[2] + "_" + name + ".npy", y)
print(json.dumps(out))
"""


def write_wav(path: str, sr: int, seconds: float, seed: int) -> None:
    import wave

    import numpy as np

    x = np.random.RandomState(seed).randn(int(sr * seconds)) * 0.2
    pcm = np.clip(x * 32767, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no card"


def main(argv=None) -> int:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="a checkout of the repo (repeat; runs in the order given)")
    ap.add_argument("--seconds", type=float, default=600.0, help="length of each file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    where = card()
    with tempfile.TemporaryDirectory() as tmp:
        files = {f"sr{sr}": os.path.join(tmp, f"long_{sr}.wav") for sr in (44100, 16000)}
        for sr, path in zip((44100, 16000), files.values()):
            write_wav(path, sr, args.seconds, args.seed)
        first = None
        for i, tree in enumerate(args.tree):
            tree = os.path.abspath(tree)
            env = dict(os.environ, PYTHONPATH=tree)
            stem = os.path.join(tmp, f"run{i}")
            res = subprocess.run([sys.executable, "-c", CHILD, json.dumps(files), stem],
                                 cwd=tree, env=env, capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stderr, file=sys.stderr)
                return 1
            out = json.loads(res.stdout.strip().splitlines()[-1])
            y = np.load(stem + "_sr44100.npy")
            first = y if first is None else first
            diff = (float(np.abs(y - first).max()) if y.shape == first.shape
                    else float("nan"))
            print(f"[load_audio_ab] run={i} tree={tree} seconds={args.seconds:g} "
                  f"torch_threads={out['torch_threads']} "
                  + " ".join(f"{k}_median_ms={v['median_ms']:.1f} "
                             f"{k}_ms={','.join(f'{t:.1f}' for t in v['ms'])}"
                             for k, v in out.items() if k.startswith("sr"))
                  + f" sr44100_max_abs_vs_run0={diff:.3g} card=\"{where}\"", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
