"""The flash attention kernel's share of its roofline over the traced
pass: one call an encoder layer a batch at (B, heads, 1500)."""

from benchmark import yardstick
from benchmark.readers import roofline


def calls(config, B, n_samples):
    call = yardstick.flash_mha_fwd(B, config["encoder_attention_heads"],
                                   config["max_source_positions"])
    return [call] * config["encoder_layers"]


def read(run):
    return roofline(run, "flash_mha", ("KeyPadding",), calls)
