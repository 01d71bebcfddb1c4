"""The positional conv kernel's share of its roofline over the traced pass:
one call a batch at (B, frames), hidden + pos_conv(hidden) in one launch of
``pos_conv_kernel``. Counted at the conv's true width (2 B L D (D / G) k
operations; hidden read and the result written once each, the weights and
the bias read once), never at a padded one, so that the share reads the same
work whatever computes it. None where the traced pass launched no such
kernel (a program that runs the library's conv), or where its launches and
the batches disagree."""

from benchmark import yardstick

KERNEL = "pos_conv_kernel"


def pos_conv_flops_bytes(config: dict, B: int, L: int) -> tuple[float, float]:
    """(operations, bytes) of one call on B clips of L frames."""
    D, G = config["hidden_size"], config["num_conv_pos_embedding_groups"]
    k = config["num_conv_pos_embeddings"]
    weights = D * (D // G) * k
    return 2.0 * B * L * weights, 2.0 * 2 * B * L * D + 2.0 * weights + 4.0 * D


def read(run):
    trace = run.record.get("trace")
    batches = run.record.get("trace_batches") or []
    if trace is None or not batches:
        return None
    seconds, launches = trace.kernel_time(KERNEL)
    if not launches or launches != len(batches):
        return None
    config = run.ctx.config
    least = sum(yardstick.bound_s(*pos_conv_flops_bytes(
        config, B, yardstick.conv_lengths(n, config["conv_kernel"], config["conv_stride"])[-1]))
        for B, n in batches)
    return 100.0 * least / seconds
