"""w2v-BERT 2.0 embedding extraction CLI on one GPU (``extract_wav2vec2``'s flags).

    python -m stutter_tpu_torch.cli.extract_w2v_bert --data_dir <corpus> \\
        --output_dir <out> --model_path <local HF checkpoint dir> \\
        [--preset fast|fidelity|turbo] [--long_files trim|chunk] [--device cuda]

The weights come from a local HF checkpoint directory (``--model_path``, or
``--model_name`` naming one: ``Wav2Vec2BertModel`` or a task model, with the
feature extractor's ``preprocessor_config.json`` beside it), or with
``--random_init`` from seed 0 in w2v-bert-2.0's architecture; a hub name
raises ``OSError`` (no download), and a checkpoint whose heads the
relative-key kernel lacks raises ``ValueError`` on a card before its weights
load. Each batch's Kaldi fbank runs on the device. The store, its columns
(states N, N - 1, N - 2 and N // 2 of the N + 1 hidden states), the
checkpoints and the batcher's defaults (240 audio-s a batch: 12 clips in the
20 s bucket, 8 in the 30 s one) are ``extract_wav2vec2``'s. ``--device``
names the torch device (default ``cuda``); with no card it fails rather than
running on the CPU. One device only: ``--devices`` above 1 raises.
"""

from __future__ import annotations

import sys

from stutter_tpu_torch.cli import extract_wav2vec2


def parse_args(argv=None):
    return extract_wav2vec2.parse_args(argv, model="w2v-BERT 2.0",
                                       model_name="facebook/w2v-bert-2.0", choices=None)


def main(argv=None) -> int:
    from stutter_tpu_torch.cli.common import load_w2v_bert_model
    from stutter_tpu_torch.extract.pipeline import W2VBertExtractor

    return extract_wav2vec2.run(parse_args(argv), "w2v_bert", load_w2v_bert_model,
                                W2VBertExtractor)


if __name__ == "__main__":
    sys.exit(main())
