"""The relative-key attention kernel's share of its roofline over the traced
pass: one call an encoder layer a batch at (B, heads, rows), each clip's key
count given. Counted by ``yardstick_conformer`` at the operation's work
(q k^T, p v and the table q E^T; q, k, v, out, E and the key counts once),
whatever implements it. None where the traced pass launched no such kernel
(a program without it), or where the calls counted from the batches, the
kernel's launches in the trace and the program's own count
(``relkey_attn_launches`` of its ``w2v_bert.layers`` spans) disagree."""

from benchmark import program_spans, yardstick, yardstick_conformer

KERNEL = "RelKeyTable"  # attention_bf16_kernel<(anonymous namespace)::RelKeyTable<...>, ...>


def calls(config, B, n_samples):
    H = config["num_attention_heads"]
    call = yardstick_conformer.relkey_attn_fwd(
        B, H, yardstick_conformer.rows(n_samples, config.get("stride", 2)),
        config["hidden_size"] // H)
    return [call] * config["num_hidden_layers"]


def program_launches(run) -> int | None:
    """The program's launches over the traced pass, or None where it counted none."""
    if program_spans.RECORDER is None:
        return None
    spans = [s for s in program_spans.RECORDER.records()
             if s.profiled and s.name == "w2v_bert.layers"]
    return sum(s.attrs.get("relkey_attn_launches", 0) for s in spans) if spans else None


def read(run):
    trace = run.record.get("trace")
    batches = run.record.get("trace_batches") or []
    if trace is None or not batches:
        return None
    seconds, launches = trace.kernel_time(KERNEL)
    all_calls = [c for B, n in batches for c in calls(run.ctx.config, B, n)]
    if not launches or not len(all_calls) == launches == program_launches(run):
        return None
    return 100.0 * sum(yardstick.bound_s(*c) for c in all_calls) / seconds
