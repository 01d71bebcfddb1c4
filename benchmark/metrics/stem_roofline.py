"""The fused WavLM stem kernel's share of its roofline over the traced
pass: one call a batch at (B, samples), each call one launch of
``stem_layer0_kernel`` and one of ``stem_conv_kernel`` for each later conv
layer. None where the traced pass launched no fused stem (a program that
runs the plain stem), or where those launches and the batches disagree."""

from benchmark import yardstick

LAYER0, CONV = "stem_layer0_kernel", "stem_conv_kernel"
LAYER0_ROWS = 16  # layer 0's taps, padded to the packed weights' first rows


def stem_flops_bytes(config: dict, B: int, n_samples: int) -> tuple[float, float]:
    """(operations, bytes) of one fused stem call on B clips of
    ``n_samples``: each conv's 2 B n_i taps_i C, with layer 0's taps its
    kernel and a later layer's k_i C; the f32 wave, the packed bf16 weights
    (layer 0's padded rows, then k_i C rows a later layer), the f32 bias and
    norm table ([layers, 3, C]) read and the last layer's bf16 frames
    written, once each."""
    C, kernels = config["conv_dim"][0], config["conv_kernel"]
    lengths = yardstick.conv_lengths(n_samples, kernels, config["conv_stride"])
    taps = [kernels[0]] + [k * C for k in kernels[1:]]
    flops = sum(2.0 * B * n * t * C for n, t in zip(lengths, taps))
    nbytes = (4.0 * B * n_samples + 2.0 * (LAYER0_ROWS + sum(k * C for k in kernels[1:])) * C
              + 4.0 * len(kernels) * 3 * C + 2.0 * B * lengths[-1] * C)
    return flops, nbytes


def read(run):
    trace = run.record.get("trace")
    batches = run.record.get("trace_batches") or []
    if trace is None or not batches:
        return None
    layer0_s, layer0_n = trace.kernel_time(LAYER0)
    conv_s, conv_n = trace.kernel_time(CONV)
    later = len(run.ctx.config["conv_kernel"]) - 1
    if layer0_n != len(batches) or conv_n != later * len(batches):
        return None
    least = sum(yardstick.bound_s(*stem_flops_bytes(run.ctx.config, B, n)) for B, n in batches)
    return 100.0 * least / (layer0_s + conv_s)
