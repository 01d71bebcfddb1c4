"""Batched, resumable WavLM embedding extraction on one device.

Counterpart of ``stutter_tpu/extract/pipeline.py`` for WavLM: the split loop
feeds length-bucketed batches through ``WavLMExtractor`` and writes the
reference's .npy+CSV store with checkpoint/resume. ``submit`` enqueues a
batch's device work and the copy of its pooled result on the current CUDA
stream without waiting for either, and ``collect`` waits for that copy alone,
so the pipeline keeps one batch in flight while it stores the previous one.
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
from stutter_tpu_torch.models.wavlm import WavLMModel, wavlm_feature_lengths

logger = logging.getLogger("stutter_tpu_torch.extract.pipeline")

PRESETS = {
    # fidelity: f32 parameters and activations, no TF32 anywhere
    "fidelity": dict(dtype=torch.float32, transfer_i16=False),
    # fast: the whole parameter set in bf16 (norms included), f32 norm
    # statistics, attention softmax and pooling; int16 waveform transfer
    "fast": dict(dtype=torch.bfloat16, transfer_i16=True),
}


def encode_waves_i16(waves) -> tuple[np.ndarray, np.ndarray]:
    """Per-clip peak-scaled int16 host->device encoding (the fast preset's).

    Scaling each clip to the full int16 range bounds the quantisation noise
    at ~3e-5 relative to that clip's peak. Returns (int16 [B, T], f32 scale
    [B])."""
    w = np.asarray(waves, np.float32)
    peak = np.max(np.abs(w), axis=1)
    scale = np.where(peak > 0, peak / 32767.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[:, None]), -32767, 32767).astype(np.int16)
    return q, scale


@contextlib.contextmanager
def _no_tf32():
    """Full f32 for matmuls and cuDNN convolutions (cuDNN defaults to TF32)."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def resolve_device(device: torch.device | str) -> torch.device:
    """The device asked for; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but torch finds no CUDA device")
    return device


class WavLMExtractor:
    """Layer-selected mean-pooled WavLM embeddings.

    ``model`` is a float32 ``WavLMModel``; the extractor moves it to
    ``device`` and casts it for ``preset``."""

    mesh = None  # single device: no data or model parallelism in this package

    def __init__(self, model: WavLMModel, device: torch.device | str,
                 layer_indices: Sequence[int] | None = None, preset: str = "fidelity"):
        if preset not in PRESETS:
            raise ValueError(f"preset {preset!r} is not ported; choose from {sorted(PRESETS)}")
        cfg = model.cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        self.preset = preset
        opts = PRESETS[preset]
        self._transfer_i16 = opts["transfer_i16"]
        self.model = model.to(device=self.device, dtype=opts["dtype"]).eval()
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

    def _precision(self):
        return _no_tf32() if self.preset == "fidelity" else contextlib.nullcontext()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":  # pinned, so the copy does not wait
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _encode(self, waves: np.ndarray, scale: np.ndarray, lengths: np.ndarray):
        w = self._to_device(waves).float() * self._to_device(scale)[:, None]
        lens = self._to_device(lengths.astype(np.int64))
        w = wavlm_prepare_batch(w, lens, self.cfg.do_normalize)
        with self._precision():
            return self.model.encode(w, self.layer_indices, sample_lengths=lens)

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


class ExtractionPipeline:
    """Split loop -> bucketed batches -> device forward -> store.

    Files longer than the top bucket keep their first top-bucket seconds (the
    reference's 'trim' policy)."""

    def __init__(self, extractor, batcher: BucketBatcher | None = None,
                 checkpoint_interval: int = 50):
        self.extractor = extractor
        if batcher is None:
            batcher = BucketBatcher(buckets_s=DEFAULT_BUCKETS_S,
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
