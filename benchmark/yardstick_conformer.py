"""Operations and bytes of w2v-BERT's Conformer encoder and of its relative-key
attention, frozen beside ``yardstick.py`` and ``yardstick_heads.py``: the
true work at the model's widths and the clip's true length, whatever
implements it. ``tests/test_bench_relkey_roofline.py`` holds the rows and
the attention's count equal to the program's own."""

from __future__ import annotations


def rows(n_samples: int, stride: int = 2) -> int:
    """The encoder rows of a clip of ``n_samples`` at 16 kHz: its Kaldi fbank
    frames (400 samples every 160) stacked ``stride`` to a row."""
    frames = (n_samples - 400) // 160 + 1 if n_samples >= 400 else 0
    return frames // stride


def relkey_attn_fwd(B: int, H: int, L: int, head_dim: int = 64, terms: int = 73,
                    elem: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one relative-key self-attention call: q k^T and
    p v over ``head_dim``, and the table T = q E^T of ``terms`` a row; q, k,
    v and the output once each in the activation dtype (``elem`` bytes), the
    [terms, head_dim] embeddings once and the [B] int32 key counts once. A
    materialised T is an implementation's cost, not the operation's."""
    n = B * H * L * head_dim
    return (4.0 * n * L + 2.0 * n * terms,
            4.0 * n * elem + 1.0 * terms * head_dim * elem + 4.0 * B)


def w2v_bert_flops(cfg: dict, n_samples: int) -> float:
    """FLOPs (MACs x 2) of one w2v-BERT forward over one clip of
    ``n_samples``, at its true rows L: the feature projection, then per row
    per layer the two FFNs 2 D F each, q, k, v, o 4 D^2, scores and values
    2 L D, T 73 D, the conv module's pointwise convs 3 D^2 and its depthwise
    conv D k MACs."""
    L = rows(n_samples, cfg.get("stride", 2))
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    terms = cfg["left_max_position_embeddings"] + cfg["right_max_position_embeddings"] + 1
    layer = (4 * D * F + 4 * D * D + 2 * L * D + terms * D + 3 * D * D
             + D * cfg["conv_depthwise_kernel_size"])
    return 2.0 * L * (cfg["feature_projection_input_dim"] * D + layer * cfg["num_hidden_layers"])
