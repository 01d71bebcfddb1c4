"""Probe: int8 operands in WavLM's long attention, against the bf16 kernel.

    python -m stutter_tpu_torch.cli.attn_int8_probe [--cases "1008,30;1504,25"] \\
        [--iters 8] [--loops 3] [--out <json>] [--device cuda]

The port's counterpart of ``scripts/attn_int8_probe.py``, with its flags,
defaults, inputs (``RandomState(0)``: q, k, v randn * 0.3 in bf16, bias
randn, gate rand, a zero mask; 16 heads of 64) and JSON keys. For each case
``L,B``: ``ops.attn_probes.int8_attention_long`` (the hand-written int8
kernels) and the incumbent, ``gated_relpos_attention`` (the bf16 kernel),
each against the f32 reference on the first two clips
(``int8_vs_f32_cosine``, ``bf16_vs_f32_cosine``, cosine distances), and
their ms per call (``int8_ms``, ``bf16_ms``: one entry per round; CUDA
events around ``--iters`` calls, the two functions in turn, after a warm
call of each) and ``speedup_min`` (the bf16 kernel's best over the int8
one's). ``block_q`` is the kernels' query tile. The int8 cosine distance is
large (~0.1-0.4) by the probe's design: its fixed 127 scale rounds a diffuse
row's probabilities to 0. One JSON line per case, then the whole result as
the last line.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    from stutter_tpu_torch.cli import _attn_probe as probe

    args = probe.parse_args("int8 operands in WavLM's long attention", argv)

    import torch

    from stutter_tpu_torch.extract.pipeline import resolve_device
    from stutter_tpu_torch.ops.attn_probes import BLOCK_Q, int8_attention_long
    from stutter_tpu_torch.ops.wavlm_attention import gated_relpos_attention

    device = resolve_device(args.device)
    out = {"metric": "attn_int8_probe", "cases": {}, **probe.device_fields(torch, device)}
    n = probe.REF_CLIPS
    for L, B in probe.cases(args.cases):
        arr = probe.probe_inputs(torch, B, L, device)
        case_out = {"B": B, "block_q": BLOCK_Q}
        ref = probe.f32_reference(torch, *arr)
        o8 = int8_attention_long(*arr)
        bf = gated_relpos_attention(*arr)
        case_out["int8_vs_f32_cosine"] = probe.cosine_distance(o8[:n], ref)
        case_out["bf16_vs_f32_cosine"] = probe.cosine_distance(bf[:n], ref)
        del ref, o8, bf
        ms = probe.time_rounds(torch, {"int8": lambda: int8_attention_long(*arr),
                                       "bf16": lambda: gated_relpos_attention(*arr)},
                               args.iters, args.loops, device)
        case_out["int8_ms"], case_out["bf16_ms"] = ms["int8"], ms["bf16"]
        case_out["speedup_min"] = min(ms["bf16"]) / min(ms["int8"])
        out["cases"][f"L{L}"] = case_out
        print(json.dumps({f"L{L}": case_out}), flush=True)
        del arr
    probe.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
