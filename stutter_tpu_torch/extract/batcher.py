"""Bucketed batching of variable-length clips (counterpart of
``stutter_tpu/extract/batcher.py``, same bucket geometry).

Clips are grouped into a small fixed set of length buckets and padded to the
bucket length; batch sizes scale inversely with bucket length so that every
batch carries about the same audio. A one-deep background thread decodes
batch i+1 while the device runs batch i. Pad rows carry ok=False.

Spans (``utils.profiling.span``): ``extract.plan`` (the bucket probe of
every file), ``extract.decode`` (one batch's decode, on the prefetch thread)
and ``extract.decode_wait`` (the loop's wait for it).

Under data parallelism every rank runs the same batcher over the same paths,
so every rank sees the same batch plan; ``batches(..., shard=(d, D))``
yields data rank d's contiguous rows of each batch (``batch_multiple = D``
makes every batch split evenly), decoding only those.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from stutter_tpu_torch.audio.wavio import audio_info, decode_batch
from stutter_tpu_torch.utils.profiling import span

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
        batch_multiple: int = 1,
        max_length_s: float | None = None,
        frame_align: tuple[int, int, int] | None = None,
    ):
        """audio_budget_s: target audio seconds per batch. batch_multiple:
        round batch sizes to a multiple of this (the data-parallel size).
        max_length_s: clips longer than the top bucket are trimmed to it.
        frame_align=(kernel, stride, multiple): snap each bucket's sample
        count up so the conv stem's frame count is a multiple of `multiple`
        (WavLM: (400, 320, 16))."""
        self.target_sr = target_sr
        if max_length_s is not None:
            buckets_s = tuple(b for b in buckets_s if b < max_length_s) + (max_length_s,)
        self.buckets_s = tuple(sorted(buckets_s))
        self.audio_budget_s = audio_budget_s
        self.max_batch = max_batch
        self.batch_multiple = batch_multiple
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
        b = max(1, min(self.max_batch, int(self.audio_budget_s / bucket_s)))
        m = self.batch_multiple
        # a multiple of m that does not pass max_batch (the memory cap) once
        # clamped to it, but never under one multiple
        if b >= self.max_batch:
            return max(m, (b // m) * m)
        return ((b + m - 1) // m) * m

    def assign_buckets(self, paths: Sequence[str],
                       durations: Sequence[float | None] | None = None,
                       ) -> dict[float, list[int]]:
        """Probe headers and group file indices by smallest covering bucket.

        ``durations`` skips the probe where the caller already knows a clip's
        length (the server probes every request once for its long-clip
        split); an entry of None is probed. A file that cannot be probed goes
        to the top bucket."""
        assignment: dict[float, list[int]] = {b: [] for b in self.buckets_s}
        top = self.buckets_s[-1]
        for i, p in enumerate(paths):
            dur = durations[i] if durations is not None else None
            if dur is None:
                try:
                    n, sr = audio_info(p)
                    dur = n / sr
                except (OSError, ValueError, struct.error) as e:
                    logger.error("cannot probe %s (%s); assigning top bucket", p, e)
                    dur = top
            bucket = next((b for b in self.buckets_s if dur <= b), top)
            assignment[bucket].append(i)
        return {b: idxs for b, idxs in assignment.items() if idxs}

    def _make_batch(self, paths: Sequence[str], rows: list[int], bucket_s: float,
                    shard: tuple[int, int] | None = None) -> Batch:
        bsz = self.batch_size_for(bucket_s)
        if shard is not None:  # data rank d of D: its slice of the padded batch
            d, n = shard
            bsz //= n
            rows = rows[d * bsz: (d + 1) * bsz]
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

    def _decode(self, index: int, paths: Sequence[str], rows: list[int], bucket_s: float,
                shard: tuple[int, int] | None) -> Batch:
        """``_make_batch`` under the ``extract.decode`` span."""
        with span("extract.decode", batch=index) as s:
            batch = self._make_batch(paths, rows, bucket_s, shard)
            n = len(batch.paths)
            s.set(clips=n, failed=n - int(batch.ok[:n].sum()))
        return batch

    def batches(self, paths: Sequence[str], prefetch: bool = True,
                shard: tuple[int, int] | None = None) -> Iterator[Batch]:
        """Yield decoded batches, prefetching the next one on a host thread.
        ``shard=(d, D)``: yield data rank d's rows of each batch, ``bsz / D``
        of them (``batch_multiple`` must be a multiple of D); a rank whose
        slice of the last batch is empty gets an all-pad batch."""
        if shard is not None and self.batch_multiple % shard[1]:
            raise ValueError(f"batch_multiple {self.batch_multiple} does not split over "
                             f"{shard[1]} data ranks")
        with span("extract.plan", files=len(paths)):
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
            for k, (bucket_s, rows) in enumerate(plan):
                yield self._decode(k, paths, rows, bucket_s, shard)
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            future = pool.submit(self._decode, 0, paths, plan[0][1], plan[0][0], shard)
            for k, nxt in enumerate(plan[1:], 1):
                with span("extract.decode_wait", batch=k - 1):
                    batch = future.result()
                future = pool.submit(self._decode, k, paths, nxt[1], nxt[0], shard)
                yield batch
            with span("extract.decode_wait", batch=len(plan) - 1):
                batch = future.result()
            yield batch

