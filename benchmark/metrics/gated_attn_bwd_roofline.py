"""The gated attention backward's share of its roofline over the traced
updates: one call a layer an update at (B, heads, frames), each call its
dq, dk-dv and dbias kernels (and the dbias sum where clips are grouped)."""

from benchmark import yardstick
from benchmark.readers import roofline


def calls(config, B, n_samples):
    L = yardstick.conv_lengths(n_samples, config["conv_kernel"], config["conv_stride"])[-1]
    call = yardstick.gated_attention_bwd(B, config["num_attention_heads"], L)
    return [call] * config["num_hidden_layers"]


def read(run):
    return roofline(run, "gated_attn_bwd", ("bwd_dq_bf16", "bwd_dkv_bf16", "bwd_dbias_bf16",
                                            "dbias_sum_kernel"), calls)
