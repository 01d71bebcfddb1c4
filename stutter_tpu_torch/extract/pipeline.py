"""Batched, resumable WavLM and Whisper embedding extraction on one device.

Counterpart of ``stutter_tpu/extract/pipeline.py``: the split loop feeds
length-bucketed batches through ``WavLMExtractor`` or ``WhisperExtractor``
and writes the reference's .npy+CSV store with checkpoint/resume. ``submit``
enqueues a batch's device work and the copy of its pooled result on the
current CUDA stream without waiting for either, and ``collect`` waits for
that copy alone, so the pipeline keeps one batch in flight while it stores
the previous one.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Sequence

import numpy as np
import torch

from stutter_tpu_torch.extract.batcher import DEFAULT_BUCKETS_S, Batch, BucketBatcher
from stutter_tpu_torch.extract.checkpoint import (
    find_latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from stutter_tpu_torch.extract.store import save_embeddings
from stutter_tpu_torch.frontend.wavlm_frontend import wavlm_prepare_batch
from stutter_tpu_torch.frontend.whisper_frontend import whisper_features
from stutter_tpu_torch.models.wavlm import (
    LONG_ATTENTION_MIN_L,
    WavLMModel,
    materialized_bias_attention,
    wavlm_feature_lengths,
)
from stutter_tpu_torch.models.whisper import WhisperModel
from stutter_tpu_torch.ops.logmel import WHISPER_HOP
from stutter_tpu_torch.ops.precision import no_tf32
from stutter_tpu_torch.ops.quant import (
    WAVLM_QUANT_KEYS,
    WHISPER_QUANT_KEYS,
    quantize_layer_stack,
)

logger = logging.getLogger("stutter_tpu_torch.extract.pipeline")

PRESETS = {
    # fidelity: f32 parameters and activations, no TF32 anywhere
    "fidelity": dict(dtype=torch.float32, transfer_i16=False),
    # fast: the whole parameter set in bf16 (norms included), f32 norm
    # statistics, attention softmax and pooling; int16 waveform transfer
    "fast": dict(dtype=torch.bfloat16, transfer_i16=True),
    # turbo: fast, then int8 W8A8 projections (ops/quant.py): WavLM's
    # q/k/v/o and FFN, the Whisper encoder's q/k/v and FFN (its attn_o and the
    # whole decoder stay bf16). Inference only; its fidelity is measured, not
    # held to the 1e-3 bar.
    "turbo": dict(dtype=torch.bfloat16, transfer_i16=True),
    # turbo_ffn: the step between turbo and fast, int8 on the FFN GEMMs only
    "turbo_ffn": dict(dtype=torch.bfloat16, transfer_i16=True),
}

_FFN_QUANT_KEYS = ("feed_forward.w1", "feed_forward.w2", "ffn.fc1_w", "ffn.fc2_w")


def cast_for_preset(model, device: torch.device, preset: str):
    """Move the float32 model to ``device`` in the preset's dtype and, for the
    turbo presets, quantize the encoder layers' weights from that bf16 cast
    (quantizing the f32 weights would give other int8 values than JAX's), as
    ``cast_params_for_preset`` does: turbo takes WavLM's six keys and the
    Whisper encoder's but ``attn.o_w``, turbo_ffn the FFN's. The Whisper
    decoder, the conv stems, biases, norms and embeddings keep the preset's
    dtype."""
    model = model.to(device=device, dtype=PRESETS[preset]["dtype"]).eval()
    whisper = isinstance(model, WhisperModel)
    keys = {"turbo": WHISPER_QUANT_KEYS if whisper else WAVLM_QUANT_KEYS,
            "turbo_ffn": _FFN_QUANT_KEYS}.get(preset)
    if keys:
        quantize_layer_stack((model.encoder if whisper else model).layers, keys)
    return model


def encode_waves_i16(waves) -> tuple[np.ndarray, np.ndarray]:
    """Per-clip peak-scaled int16 host->device encoding (the bf16 presets').

    Scaling each clip to the full int16 range bounds the quantisation noise
    at ~3e-5 relative to that clip's peak. Returns (int16 [B, T], f32 scale
    [B])."""
    w = np.asarray(waves, np.float32)
    peak = np.max(np.abs(w), axis=1)
    scale = np.where(peak > 0, peak / 32767.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[:, None]), -32767, 32767).astype(np.int16)
    return q, scale


def resolve_device(device: torch.device | str) -> torch.device:
    """The device asked for; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but torch finds no CUDA device")
    return device


class _Extractor:
    """What both extractors share: the device, the preset's cast (and turbo's
    quantization) of the float32 model, and the batch loop's
    submit/collect/warmup. A subclass sets ``column_names`` (the order of
    ``_encode``'s [S, B, D] result) and defines ``_encode``."""

    mesh = None  # single device: no data or model parallelism in this package
    column_names: list[str]

    def __init__(self, model, device: torch.device | str, preset: str):
        if preset not in PRESETS:
            raise ValueError(f"unknown preset {preset!r}; choose from {sorted(PRESETS)}")
        self.cfg = model.cfg
        self.device = resolve_device(device)
        self.preset = preset
        self._transfer_i16 = PRESETS[preset]["transfer_i16"]
        self.model = cast_for_preset(model, self.device, preset)

    def _precision(self):
        return no_tf32() if self.preset == "fidelity" else contextlib.nullcontext()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":  # pinned, so the copy does not wait
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _waves(self, waves: np.ndarray, scale: np.ndarray) -> torch.Tensor:
        """Host batch (f32, or int16 with per-clip scales) -> f32 on the device."""
        return self._to_device(waves).float() * self._to_device(scale)[:, None]

    def _encode(self, waves: np.ndarray, scale: np.ndarray,
                lengths: np.ndarray) -> torch.Tensor:
        raise NotImplementedError

    def submit(self, batch: Batch):
        """Enqueue the batch's device work and the copy of its [S, B, D] f32
        pooled result into pinned host memory, without waiting for either;
        returns (host tensor, CUDA event or None)."""
        waves = batch.waves
        scale = np.ones((len(waves),), np.float32)
        if self._transfer_i16:
            waves, scale = encode_waves_i16(waves)
        pooled = self._encode(waves, scale, batch.lengths)
        if self.device.type != "cuda":
            return pooled, None
        host = torch.empty(pooled.shape, dtype=pooled.dtype, pin_memory=True)
        host.copy_(pooled, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    def collect(self, handle) -> dict[str, np.ndarray]:
        host, done = handle
        if done is not None:
            done.synchronize()  # this batch's copy only, not later batches
        pooled = host.numpy()
        return {name: pooled[s] for s, name in enumerate(self.column_names)}

    def __call__(self, batch: Batch) -> dict[str, np.ndarray]:
        return self.collect(self.submit(batch))

    def warmup(self, batcher: BucketBatcher) -> int:
        """Run one silent batch per bucket shape (builds the kernels, warms
        cuDNN and the allocator); returns the number of buckets run."""
        count = 0
        for bucket_s in batcher.buckets_s:
            B, n = batcher.batch_size_for(bucket_s), batcher.bucket_samples(bucket_s)
            t0 = time.perf_counter()
            waves = np.zeros((B, n), np.int16 if self._transfer_i16 else np.float32)
            self._encode(waves, np.ones((B,), np.float32), np.full((B,), n, np.int64)).cpu()
            logger.info("warmup: bucket %.1fs [B=%d, n=%d] ran in %.2fs",
                        bucket_s, B, n, time.perf_counter() - t0)
            count += 1
        return count


class WavLMExtractor(_Extractor):
    """Layer-selected mean-pooled WavLM embeddings.

    ``model`` is a float32 ``WavLMModel``; the extractor moves it to
    ``device`` and casts it for ``preset``. ``long_attention`` picks the
    attention of the long buckets: "gated" (the default, as in the JAX
    package) sends every call to ``gated_relpos_attention``;
    "materialized_bias" takes the JAX package's escape hatch
    (``models.wavlm.materialized_bias_attention``) from ``long_min_l``
    frames up, in bf16."""

    LONG_ATTENTION = ("gated", "materialized_bias")

    def __init__(self, model: WavLMModel, device: torch.device | str,
                 layer_indices: Sequence[int] | None = None, preset: str = "fidelity",
                 long_attention: str = "gated", long_min_l: int = LONG_ATTENTION_MIN_L):
        if long_attention not in self.LONG_ATTENTION:
            raise ValueError(f"long_attention must be one of {self.LONG_ATTENTION}, "
                             f"got {long_attention!r}")
        super().__init__(model, device, preset)
        # None: encode's default, the gated kernel wrapper
        self.attention_fn = (materialized_bias_attention(long_min_l)
                             if long_attention == "materialized_bias" else None)
        cfg = self.cfg
        n_states = cfg.num_hidden_layers + 1
        # reference default: [N-1, N-2, N-3, N//2] of the N+1 states
        self.layer_indices = tuple(
            layer_indices if layer_indices is not None
            else (n_states - 1, n_states - 2, n_states - 3, n_states // 2))
        self.embedding_dim = cfg.hidden_size
        self.column_names = [f"layer_{i}" for i in self.layer_indices]
        self.frame_align = (*cfg.stem_geometry, 16)

    def frame_count(self, n_samples: int) -> int:
        return int(wavlm_feature_lengths(self.cfg, n_samples))

    def _encode(self, waves: np.ndarray, scale: np.ndarray, lengths: np.ndarray):
        lens = self._to_device(lengths.astype(np.int64))
        w = wavlm_prepare_batch(self._waves(waves, scale), lens, self.cfg.do_normalize)
        with self._precision():
            return self.model.encode(w, self.layer_indices, sample_lengths=lens,
                                     attention_fn=self.attention_fn)


class WhisperExtractor(_Extractor):
    """Whisper encoder mean-pooled and decoder single-token embeddings.

    Keeps the reference's quirks: the 30 s zero-padded mel is attended in
    full and the encoder pool is over all 1500 frames, padding included;
    the decoder runs exactly one step with token id 0. ``model`` is a
    float32 ``WhisperModel``; the extractor moves it to ``device`` and casts
    it for ``preset`` (fast: the whole tree in bf16, embeddings included)."""

    preferred_buckets = (30.0,)

    def __init__(self, model: WhisperModel, device: torch.device | str,
                 encoder_indices: Sequence[int] | None = None,
                 decoder_indices: Sequence[int] | None = None, preset: str = "fidelity"):
        super().__init__(model, device, preset)
        cfg = self.cfg
        n_enc, n_dec = cfg.encoder_layers + 1, cfg.decoder_layers + 1
        # reference: the last three hidden states of each
        self.encoder_indices = tuple(
            encoder_indices if encoder_indices is not None
            else (n_enc - 1, n_enc - 2, n_enc - 3))
        self.decoder_indices = tuple(
            decoder_indices if decoder_indices is not None
            else (n_dec - 1, n_dec - 2, n_dec - 3))
        self.embedding_dim = cfg.d_model
        self.column_names = ([f"encoder_layer_{i}" for i in self.encoder_indices]
                             + [f"decoder_layer_{i}" for i in self.decoder_indices])

    def frame_count(self, n_samples: int) -> int:
        """True encoder frames covering n_samples of audio (mel hop 160, conv
        stem stride 2), capped at the 1500 positions. The encoder itself
        still pools over all 1500 padded positions."""
        return max(1, min(self.cfg.max_source_positions, int(n_samples) // (WHISPER_HOP * 2)))

    def _encode(self, waves: np.ndarray, scale: np.ndarray, lengths: np.ndarray):
        with self._precision():
            mel = whisper_features(self._waves(waves, scale), n_mels=self.cfg.num_mel_bins)
            return self.model.embed(mel, self.encoder_indices, self.decoder_indices)


class ExtractionPipeline:
    """Split loop -> bucketed batches -> device forward -> store.

    Files longer than the top bucket keep their first top-bucket seconds (the
    reference's 'trim' policy)."""

    def __init__(self, extractor, batcher: BucketBatcher | None = None,
                 checkpoint_interval: int = 50):
        self.extractor = extractor
        if batcher is None:
            batcher = BucketBatcher(
                buckets_s=getattr(extractor, "preferred_buckets", None) or DEFAULT_BUCKETS_S,
                frame_align=getattr(extractor, "frame_align", None))
        self.batcher = batcher
        self.checkpoint_interval = checkpoint_interval

    def run_split(self, metadata: list[dict], split: str, output_dir: str,
                  resume: bool = False) -> list[dict]:
        """Extract one split, honouring checkpoint/resume, and persist it."""
        split_rows = [r for r in metadata if r.get("split") == split]
        if not split_rows:
            logger.warning("no files for split %s", split)
            return []

        results: list[dict] = []
        ckpt_num = 0
        if resume:
            latest = find_latest_checkpoint(output_dir, split)
            if latest is not None:
                results = load_checkpoint(output_dir, split, latest)
                ckpt_num = latest
        done_paths = {r["path"] for r in results}
        todo = [r for r in split_rows if r["path"] not in done_paths]
        paths = [r["path"] for r in todo]

        t0 = time.perf_counter()
        audio_s = 0.0
        since_ckpt = 0

        def drain(batch: Batch, handle) -> None:
            nonlocal audio_s, since_ckpt, ckpt_num
            embeddings = self.extractor.collect(handle)
            for j, row_idx in enumerate(batch.rows):
                if not batch.ok[j]:
                    logger.error("skipping %s (decode failed)", batch.paths[j])
                    continue
                meta_row = todo[row_idx]
                entry = {"filename": meta_row["filename"], "path": meta_row["path"],
                         "split": split}
                if meta_row.get("label") not in (None, ""):
                    entry["label"] = meta_row["label"]
                for col, arr in embeddings.items():
                    entry[col] = np.asarray(arr[j], np.float32)
                results.append(entry)
                since_ckpt += 1
            audio_s += batch.audio_seconds
            if since_ckpt >= self.checkpoint_interval:
                ckpt_num += 1
                save_checkpoint(results, output_dir, split, ckpt_num)
                since_ckpt = 0

        # 1-deep: batch i+1 is enqueued on the device before batch i's pooled
        # result is copied back and stored
        pending = None
        for batch in self.batcher.batches(paths):
            handle = self.extractor.submit(batch)
            if pending is not None:
                drain(*pending)
            pending = (batch, handle)
        if pending is not None:
            drain(*pending)

        wall = time.perf_counter() - t0
        if wall > 0 and audio_s > 0:
            logger.info("split %s: %d files, %.1f audio-s in %.1f s (%.1fx real-time)",
                        split, len(results), audio_s, wall, audio_s / wall)
        results = sorted(results, key=lambda r: r["path"])
        save_embeddings(results, output_dir, split,
                        expected_dim=self.extractor.embedding_dim)
        return results

    def run(self, metadata: list[dict], output_dir: str,
            splits: Sequence[str] = ("train", "test", "devel"),
            resume: bool = False) -> dict[str, list[dict]]:
        return {s: self.run_split(metadata, s, output_dir, resume=resume) for s in splits}
