"""WavLM + Whisper serving extractor: the fusion store's columns, live
(counterpart of ``stutter_tpu/serve/combined.py``).

One request's audio runs through both backbones and comes back under the
fusion store's column names (``wavlm_layer_24``, ``whisper_encoder_layer_32``,
... and ``combined_top``, the parts' top layers side by side, as
``extract/store.py:load_embeddings_combined`` builds them), so that a model
trained on ``--model_type combined`` classifies live audio through the
ordinary ``EmbeddingServer`` and ``ServingClassifier``. Both parts' device
work is enqueued before either is collected. Under a plan both parts take
the same one; the server gathers each rank's rows, ``combined_top`` among
them (the parts' rows side by side, the same bits on whichever rank they
are joined), to rank 0.
"""

from __future__ import annotations

import numpy as np

from stutter_tpu_torch.extract.store import combined_top_key


class CombinedExtractor:
    """An extractor (``submit``/``collect``/``column_names``) over two parts.

    It serves Whisper's single 30 s bucket: Whisper pads every clip to 30 s
    anyway, and WavLM's masked statistics and pooling make its embeddings
    independent of the padding, so one padded batch serves both parts."""

    preferred_buckets = (30.0,)

    def __init__(self, wavlm_extractor, whisper_extractor):
        self.plan = getattr(wavlm_extractor, "plan", None)
        if getattr(whisper_extractor, "plan", None) is not self.plan:
            raise ValueError("both parts of a CombinedExtractor take the same plan")
        self.parts = (("wavlm", wavlm_extractor), ("whisper", whisper_extractor))
        self.column_names = [f"{name}_{col}" for name, part in self.parts
                             for col in part.column_names] + ["combined_top"]
        # chunk weights count true audio: WavLM's frames (Whisper's stop at 1500)
        self.frame_count = wavlm_extractor.frame_count
        self.embedding_dim = wavlm_extractor.embedding_dim + whisper_extractor.embedding_dim
        # no frame_align: the 30 s bucket stays exactly 480 000 samples
        self._top_cols = tuple(f"{name}_{combined_top_key(part.column_names)}"
                               for name, part in self.parts)

    def warmup(self, batcher) -> int:
        """Both parts' warm batches (see ``extract/pipeline.py``)."""
        return sum(part.warmup(batcher) for _, part in self.parts)

    def submit(self, batch):
        return tuple(part.submit(batch) for _, part in self.parts)

    def collect(self, handles) -> dict[str, np.ndarray]:
        out: dict[str, np.ndarray] = {}
        for (name, part), handle in zip(self.parts, handles):
            for col, arr in part.collect(handle).items():
                out[f"{name}_{col}"] = arr
        out["combined_top"] = np.hstack([out[c] for c in self._top_cols])
        return out

    def __call__(self, batch) -> dict[str, np.ndarray]:
        return self.collect(self.submit(batch))
