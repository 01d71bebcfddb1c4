"""Bucketed batching of variable-length clips (counterpart of
``stutter_tpu/extract/batcher.py``, same bucket geometry).

Clips are grouped into a small fixed set of length buckets and padded to the
bucket length; batch sizes scale inversely with bucket length so that every
batch carries about the same audio. A one-deep background thread decodes
batch i+1 while the device runs batch i. Pad rows carry ok=False.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from stutter_tpu_torch.audio.wavio import decode_batch, wav_info

logger = logging.getLogger("stutter_tpu_torch.extract.batcher")

DEFAULT_BUCKETS_S = (1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 20.0, 30.0)


@dataclasses.dataclass
class Batch:
    paths: list[str]
    rows: list[int]  # indices into the source metadata
    waves: np.ndarray  # [B, bucket_samples] float32, zero padded
    lengths: np.ndarray  # [B] int64 true sample counts (0 for pad rows)
    ok: np.ndarray  # [B] bool (False: decode failure or pad row)
    bucket_s: float
    sample_rate: int = 16000

    @property
    def audio_seconds(self) -> float:
        return float(self.lengths.sum()) / float(self.sample_rate)


class BucketBatcher:
    def __init__(
        self,
        target_sr: int = 16000,
        buckets_s: Sequence[float] = DEFAULT_BUCKETS_S,
        audio_budget_s: float = 384.0,
        max_batch: int = 128,
        max_length_s: float | None = None,
        frame_align: tuple[int, int, int] | None = None,
    ):
        """audio_budget_s: target audio seconds per batch. max_length_s: clips
        longer than the top bucket are trimmed to it.
        frame_align=(kernel, stride, multiple): snap each bucket's sample
        count up so the conv stem's frame count is a multiple of `multiple`
        (WavLM: (400, 320, 16))."""
        self.target_sr = target_sr
        if max_length_s is not None:
            buckets_s = tuple(b for b in buckets_s if b < max_length_s) + (max_length_s,)
        self.buckets_s = tuple(sorted(buckets_s))
        self.audio_budget_s = audio_budget_s
        self.max_batch = max_batch
        self.frame_align = frame_align

    def bucket_samples(self, bucket_s: float) -> int:
        """Padded sample count for a bucket, optionally frame-aligned."""
        n = int(bucket_s * self.target_sr)
        if self.frame_align is None:
            return n
        k, s, m = self.frame_align
        frames = max(1, (n - k) // s + 1)
        frames = ((frames + m - 1) // m) * m
        return (frames - 1) * s + k

    def batch_size_for(self, bucket_s: float) -> int:
        return max(1, min(self.max_batch, int(self.audio_budget_s / bucket_s)))

    def assign_buckets(self, paths: Sequence[str]) -> dict[float, list[int]]:
        """Probe headers and group file indices by smallest covering bucket."""
        assignment: dict[float, list[int]] = {b: [] for b in self.buckets_s}
        top = self.buckets_s[-1]
        for i, p in enumerate(paths):
            try:
                n, sr = wav_info(p)
                dur = n / sr
            except (OSError, ValueError, struct.error) as e:
                logger.error("cannot probe %s (%s); assigning top bucket", p, e)
                dur = top
            bucket = next((b for b in self.buckets_s if dur <= b), top)
            assignment[bucket].append(i)
        return {b: idxs for b, idxs in assignment.items() if idxs}

    def _make_batch(self, paths: Sequence[str], rows: list[int], bucket_s: float) -> Batch:
        bsz = self.batch_size_for(bucket_s)
        max_samples = self.bucket_samples(bucket_s)
        batch_paths = [paths[r] for r in rows]
        waves, lengths, ok = decode_batch(batch_paths, target_sr=self.target_sr,
                                          max_samples=max_samples)
        pad = bsz - len(rows)
        if pad > 0:
            waves = np.concatenate([waves, np.zeros((pad, max_samples), np.float32)])
            lengths = np.concatenate([lengths, np.zeros((pad,), np.int64)])
            ok = np.concatenate([ok, np.zeros((pad,), bool)])
        return Batch(paths=batch_paths, rows=list(rows), waves=waves, lengths=lengths,
                     ok=ok, bucket_s=bucket_s, sample_rate=self.target_sr)

    def batches(self, paths: Sequence[str], prefetch: bool = True) -> Iterator[Batch]:
        """Yield decoded batches, prefetching the next one on a host thread."""
        assignment = self.assign_buckets(paths)
        plan: list[tuple[float, list[int]]] = []
        for bucket_s, idxs in assignment.items():
            bsz = self.batch_size_for(bucket_s)
            for i in range(0, len(idxs), bsz):
                plan.append((bucket_s, idxs[i: i + bsz]))
        logger.info("batch plan: %d batches over %d buckets for %d files",
                    len(plan), len(assignment), len(paths))
        if not plan:
            return
        if not prefetch:
            for bucket_s, rows in plan:
                yield self._make_batch(paths, rows, bucket_s)
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(self._make_batch, paths, plan[0][1], plan[0][0])
            for nxt in plan[1:]:
                batch = future.result()
                future = pool.submit(self._make_batch, paths, nxt[1], nxt[0])
                yield batch
            yield future.result()

