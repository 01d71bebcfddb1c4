"""The flash attention kernel's share of its roofline at head_dim 120 over
the traced pass: one call an encoder layer a batch at (B, heads, frames),
each clip's key count given. Counted at the true width, 120 (never the 128
that the kernel pads q . k^T to), by ``yardstick_heads``. None where the
traced pass launched no 120-wide flash kernel (a program without it), or
where its launches and the batches disagree (a 64-wide launch counts in
the wrapper's launches but not among the kernel's)."""

from benchmark import yardstick, yardstick_heads
from benchmark.readers import roofline

KERNEL = "KeyPadding, 120"  # attention_bf16_kernel<(anonymous namespace)::KeyPadding, 120, ...>


def calls(config, B, n_samples):
    L = yardstick.conv_lengths(n_samples, config["conv_kernel"], config["conv_stride"])[-1]
    H = config["num_attention_heads"]
    call = yardstick_heads.flash_mha_fwd(B, H, L, config["hidden_size"] // H)
    return [call] * config["num_hidden_layers"]


def read(run):
    return roofline(run, "flash_mha", (KERNEL,), calls)
