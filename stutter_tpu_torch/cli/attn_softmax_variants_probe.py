"""Probe: softmax-chain variants of WavLM's long attention, against the bf16 kernel.

    python -m stutter_tpu_torch.cli.attn_softmax_variants_probe \\
        [--cases "1008,30;1504,25"] [--iters 8] [--loops 3] [--out <json>] [--device cuda]

The port's counterpart of ``scripts/attn_softmax_variants_probe.py``, with
its flags, defaults, inputs (``RandomState(0)``, as
``cli/attn_int8_probe.py``) and JSON keys. For each case ``L,B``, the four
variants of ``ops.attn_probes.softmax_variant_attention`` (the hand-written
kernel templated on postnorm and bf16chain): ``A_incumbent`` (f32 chain,
normalise, then a . v), ``B_postnorm`` (a . v on the unnormalised e, divide
after), ``C_bf16chain`` (the chain in bf16) and ``D_both``. Each
``<name>_cosine`` is its cosine distance from the f32 reference on the first
two clips; ``<name>_ms`` and ``src_incumbent_ms`` (``gated_relpos_attention``,
the port's bf16 kernel, as the absolute baseline) are ms per call, one entry
per round: CUDA events around ``--iters`` calls, the five functions in turn,
after a warm call of each. ``block_q`` is the kernels' query tile. One JSON
line per case, then the whole result as the last line.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    from stutter_tpu_torch.cli import _attn_probe as probe

    args = probe.parse_args("softmax-chain variants of WavLM's long attention", argv)

    import torch

    from stutter_tpu_torch.extract.pipeline import resolve_device
    from stutter_tpu_torch.ops.attn_probes import (
        BLOCK_Q,
        VARIANTS,
        softmax_variant_attention,
    )
    from stutter_tpu_torch.ops.wavlm_attention import gated_relpos_attention

    device = resolve_device(args.device)
    out = {"metric": "attn_softmax_variants_probe", "cases": {},
           **probe.device_fields(torch, device)}
    n = probe.REF_CLIPS
    for L, B in probe.cases(args.cases):
        arr = probe.probe_inputs(torch, B, L, device)
        case_out = {"B": B, "block_q": BLOCK_Q}
        ref = probe.f32_reference(torch, *arr)
        fns = {}
        for name, (postnorm, bf16chain) in VARIANTS.items():
            o = softmax_variant_attention(*arr, postnorm, bf16chain)
            case_out[name + "_cosine"] = probe.cosine_distance(o[:n], ref)
            fns[name] = lambda pn=postnorm, bc=bf16chain: softmax_variant_attention(*arr, pn, bc)
        del ref, o
        fns["src_incumbent"] = lambda: gated_relpos_attention(*arr)
        for name, times in probe.time_rounds(torch, fns, args.iters, args.loops,
                                             device).items():
            case_out[name + "_ms"] = times
        out["cases"][f"L{L}"] = case_out
        print(json.dumps({f"L{L}": case_out}), flush=True)
        del arr, fns
    probe.emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
