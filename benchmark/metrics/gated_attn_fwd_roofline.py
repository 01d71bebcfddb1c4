"""The gated relative-position attention kernel's share of its roofline
over the traced pass: one call a layer a batch at (B, heads, frames)."""

from benchmark import yardstick
from benchmark.readers import roofline


def calls(config, B, n_samples):
    L = yardstick.conv_lengths(n_samples, config["conv_kernel"], config["conv_stride"])[-1]
    call = yardstick.gated_attention_fwd(B, config["num_attention_heads"], L)
    return [call] * config["num_hidden_layers"]


def read(run):
    return roofline(run, "gated_attn_fwd", ("GatedBiasRing",), calls)
