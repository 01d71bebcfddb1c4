"""Latency-bounded online embedding serving over the extraction stack
(counterpart of ``stutter_tpu/serve/server.py``).

The same ``BucketBatcher`` buckets and the same extractors serve interactive
requests; the server adds a deadline-bounded gather, so that a lone request
never waits for a full batch.

- A reader thread drains the request source into a queue, so that a slow
  client does not stall the device loop.
- The serving loop gathers requests until ``max_wait_s`` has passed since
  the first one or ``max_clips`` are waiting, groups them by length bucket,
  submits each bucket batch, and emits one response per request.
- One round is in flight: round k's device work runs while round k+1
  gathers and decodes. Submitting enqueues a batch on the card without
  waiting (``extractor.submit``); ``extractor.collect``, when the round is
  finished, is the only place that waits on the device.
- Clips longer than the top bucket are chunked (``chunked_embeddings``) or
  trimmed to it (``long_clip_policy``).
- A failed batch answers only its own requests, and no request is answered
  twice; a classifier error still ships the embeddings.

Under the extractor's plan (``parallel.mesh.MeshPlan``, one process a card)
rank 0 runs this loop and every other rank runs ``follow``. Rank 0 sends
each round to the followers before it submits it (``broadcast_round``): the
paths of each bucket batch, in submit order, and the long clips' paths.
Each rank decodes and encodes its own rows of each batch
(``extract.pipeline.submit_rows``), so every rank must see the same files at
the same paths. Where rank 0 finishes a round it sends "finish", and every
rank collects and gathers that round's rows to rank 0
(``collect_rows``); a batch that fails on any rank fails its own requests
on rank 0, and every rank goes on to the next. Rank 0 alone emits,
classifies and keeps the stats. A rank 0 with no traffic sends "idle"
every ``idle_interval_s()``, so that its followers never wait in a
collective for the group's whole timeout, and "stop" when its source ends.
The JAX server shards each batch over its mesh inside its one loop; this is
that loop with one process per card.

Spans (``utils.profiling.span``): per request ``serve.wait``, from its
arrival (the reader thread's stamp as it queues the request) to the start
of its round's submit; per round ``serve.round``, the loop's pass from the
round's first request, with its children ``serve.gather``, ``serve.probe``
(the long-clip split's header reads), ``serve.decode`` and ``serve.submit``
(each bucket batch), then the previous round's ``serve.collect_wait``,
``serve.chunked`` (a long clip's whole path) and ``serve.emit`` (classify
and emit); ``serve.idle``, the wait for a first request with no round in
flight. ``stats()`` times each request from the same arrival stamp, and
its ``device_collect_s`` is the sum of ``serve.collect_wait`` and
``serve.chunked``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import queue
import struct
import threading
import time
from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np

from stutter_tpu_torch.audio.wavio import audio_info
from stutter_tpu_torch.extract.batcher import Batch, BucketBatcher
from stutter_tpu_torch.extract.pipeline import chunked_embeddings, collect_rows, submit_rows
from stutter_tpu_torch.parallel.mesh import broadcast_round, idle_interval_s
from stutter_tpu_torch.utils.profiling import record, span, timed

logger = logging.getLogger("stutter_tpu_torch.serve.server")


@dataclasses.dataclass
class Request:
    req_id: str
    path: str


@dataclasses.dataclass
class Response:
    req_id: str
    path: str
    ok: bool
    embeddings: dict[str, np.ndarray] | None  # column -> [D] f32
    error: str | None = None
    # with a ServingClassifier: the predicted label and per-class
    # probabilities (None where the model has no predict_proba)
    prediction: str | None = None
    probs: dict[str, float] | None = None


_STOP = object()


class EmbeddingServer:
    def __init__(self, extractor, batcher: BucketBatcher | None = None,
                 max_wait_s: float = 0.25, max_clips: int = 64, stats_every: int = 20,
                 long_clip_policy: str = "chunk", classifier=None):
        if long_clip_policy not in ("trim", "chunk"):
            raise ValueError(f"long_clip_policy must be 'trim' or 'chunk', "
                             f"got {long_clip_policy!r}")
        self.extractor = extractor
        self.plan = getattr(extractor, "plan", None)
        # checked against the extractor's columns now, so that a layer
        # mismatch fails at startup rather than on every request
        self.classifier = classifier
        cols = getattr(extractor, "column_names", None)
        if classifier is not None and cols and classifier.layer not in cols:
            raise ValueError(f"classifier was trained on column '{classifier.layer}' but the "
                             f"extractor serves columns {list(cols)}")
        data = self.plan.data_size if self.plan is not None else 1
        self.batcher = batcher or BucketBatcher(audio_budget_s=max_clips * 3.0,
                                                max_batch=max_clips, batch_multiple=data)
        if self.batcher.batch_multiple % data:
            raise ValueError(f"the batcher's batch_multiple {self.batcher.batch_multiple} does "
                             f"not split over {data} data ranks")
        self.max_wait_s = max_wait_s
        self.max_clips = max_clips
        self.long_clip_policy = long_clip_policy
        self.stats_every = stats_every
        # latency from arrival (the reader queues the request) to response,
        # the last 100k requests
        self._latencies: deque[float] = deque(maxlen=100_000)
        self._served = self._failed = self._rounds = 0
        # time spent waiting in collect() and in the chunked path, and the
        # audio seconds they produced: device_s_per_audio_s, the serving
        # loop's and the device's cost per unit of work whatever the pacing
        self._collect_s = 0.0
        self._audio_s = 0.0

    def reset_stats(self) -> None:
        """Zero the counters (after a warm-up, before measuring)."""
        self._latencies.clear()
        self._served = self._failed = self._rounds = 0
        self._collect_s = self._audio_s = 0.0

    def stats(self) -> dict:
        """Counters since startup; latency percentiles over the last 100k
        requests (seconds), each from its arrival in the queue to its
        response."""
        lat = np.asarray(self._latencies, np.float64)
        out = {"served": self._served, "failed": self._failed, "rounds": self._rounds,
               "device_collect_s": round(self._collect_s, 3),
               "audio_s_served": round(self._audio_s, 2)}
        if self._audio_s > 0:
            out["device_s_per_audio_s"] = round(self._collect_s / self._audio_s, 4)
        if len(lat):
            out.update(p50_s=float(np.percentile(lat, 50)), p95_s=float(np.percentile(lat, 95)),
                       max_s=float(lat.max()))
        return out

    # -- one gathered round ------------------------------------------------

    def _send(self, *msg) -> None:
        """Rank 0: one message to the followers (nothing without a plan)."""
        if self.plan is not None:
            broadcast_round(self.plan, msg)

    def _submit_batch(self, bucket_s: float, paths: list[str], k: int = 0):
        """Decode this rank's rows of one bucket batch of ``paths`` and
        enqueue them (``submit_rows``); a decode or submit error comes back
        in the handle's place, as ``collect_rows`` raises it."""
        shard = None if self.plan is None else (self.plan.data_rank, self.plan.data_size)
        try:
            with span("serve.decode", batch=k, clips=len(paths)):
                batch = self.batcher._make_batch(paths, list(range(len(paths))), bucket_s, shard)
        except Exception as e:  # noqa: BLE001 — fails this batch's requests only
            logger.exception("batch decode failed")
            return Batch(paths=[], rows=[], waves=np.zeros((0, 0), np.float32),
                         lengths=np.zeros((0,), np.int64), ok=np.zeros((0,), bool),
                         bucket_s=bucket_s), e
        with span("serve.submit", batch=k, clips=len(paths)):
            submitted = submit_rows(self.extractor, batch, sharded=True)
        if isinstance(submitted[1], Exception):
            logger.error("batch submit failed: %r", submitted[1])
        return submitted

    def _submit_round(self, reqs: list[Request]):
        """The round's host half: probe and split off the long clips, assign
        the buckets, send the round to the followers, then decode and submit
        every bucket batch without waiting for the device. Returns the work
        ``_finish_round`` takes."""
        long_reqs: list[Request] = []
        durations: list[float | None] | None = None
        if self.long_clip_policy == "chunk":
            top_s = self.batcher.buckets_s[-1]
            short: list[Request] = []
            durations = []
            with span("serve.probe", clips=len(reqs)):
                for r in reqs:
                    try:
                        n, sr = audio_info(r.path)
                        dur = n / sr
                    except (OSError, ValueError, struct.error):
                        dur = None  # the batch path reports the file
                    if dur is not None and dur > top_s:
                        long_reqs.append(r)
                    else:
                        short.append(r)
                        durations.append(dur)  # assign_buckets need not probe again
            reqs = short
        assignment = self.batcher.assign_buckets([r.path for r in reqs], durations=durations)
        batches = []  # (bucket, requests of the batch)
        for bucket_s, rows in assignment.items():
            bsz = self.batcher.batch_size_for(bucket_s)
            batches.extend((bucket_s, [reqs[r] for r in rows[i: i + bsz]])
                           for i in range(0, len(rows), bsz))
        # from here on every step is taken on every rank
        self._send("round", [(b, [r.path for r in rs]) for b, rs in batches],
                   [r.path for r in long_reqs])
        pending = [(rs, self._submit_batch(b, [r.path for r in rs], k))
                   for k, (b, rs) in enumerate(batches)]
        return pending, long_reqs

    def _finish_round(self, work, emit: Callable[[Response], None], emitted: set[str],
                      round_no: int = 0):
        """Collect, classify and emit a submitted round. Every emit is
        recorded in ``emitted``, so that a failure part way through never
        answers a request twice; a failed batch fails its own requests."""
        pending, long_reqs = work
        for k, (chunk_reqs, submitted) in enumerate(pending):
            try:
                with timed("serve.collect_wait", round=round_no, batch=k) as waited:
                    got = collect_rows(self.extractor, submitted)
                self._collect_s += waited.seconds
                self._audio_s += got.audio_seconds
            except Exception as e:  # noqa: BLE001
                logger.exception("batch failed")
                for req in chunk_reqs:
                    emitted.add(req.req_id)
                    emit(Response(req.req_id, req.path, False, None, f"batch failed: {e}"))
                continue
            with span("serve.emit", round=round_no, batch=k, clips=len(chunk_reqs)):
                cols, ok = got.columns, got.ok
                # one classifier call for the whole batch
                preds: dict[int, tuple[str, dict | None]] = {}
                classify_err = None
                if self.classifier is not None:
                    valid = [j for j in range(len(chunk_reqs)) if ok[j]]
                    try:
                        rows = np.asarray(cols[self.classifier.layer], np.float32)[valid]
                        labels, probs = self.classifier.predict_rows(rows)
                        preds = {j: (labels[i], probs[i] if probs else None)
                                 for i, j in enumerate(valid)}
                    except Exception as e:  # noqa: BLE001 — the embeddings still ship
                        logger.exception("classification failed for batch")
                        classify_err = f"classification failed: {e}"
                for j, req in enumerate(chunk_reqs):
                    emitted.add(req.req_id)
                    if not ok[j]:
                        emit(Response(req.req_id, req.path, False, None, "decode failed"))
                        continue
                    label, probs_j = preds.get(j, (None, None))
                    emit(Response(req.req_id, req.path, True,
                                  {name: np.asarray(col[j], np.float32)
                                   for name, col in cols.items()},
                                  error=classify_err, prediction=label, probs=probs_j))
        for req in long_reqs:
            emitted.add(req.req_id)
            try:
                with timed("serve.chunked", round=round_no) as waited:
                    res = chunked_embeddings(self.extractor, self.batcher, req.path)
                self._collect_s += waited.seconds
                if res is not None:
                    self._audio_s += res[2]
            except Exception as e:  # noqa: BLE001 — one bad clip must not end the round
                logger.exception("chunked extraction failed for %s", req.path)
                emit(Response(req.req_id, req.path, False, None,
                              f"chunked extraction failed: {e}"))
                continue
            if res is None:
                emit(Response(req.req_id, req.path, False, None, "decode failed"))
                continue
            label, probs, classify_err = None, None, None
            if self.classifier is not None:
                try:
                    label, probs = self.classifier.classify_embeddings(res[0])
                except Exception as e:  # noqa: BLE001 — the embeddings still ship
                    logger.exception("classification failed for %s", req.path)
                    classify_err = f"classification failed: {e}"
            emit(Response(req.req_id, req.path, True, res[0], error=classify_err,
                          prediction=label, probs=probs))

    # -- serving loop ------------------------------------------------------

    def _finish_pending(self, pending) -> None:
        """Finish a submitted round (the followers theirs): collect, emit,
        never answer twice."""
        work, gathered, tracked_emit, emitted, t0, round_no = pending
        self._send("finish")
        try:
            self._finish_round(work, tracked_emit, emitted, round_no)
        except Exception as e:  # noqa: BLE001 — a bad round must not end the server
            logger.exception("serving round failed")
            for r in gathered:
                if r.req_id not in emitted:
                    tracked_emit(Response(r.req_id, r.path, False, None, f"round failed: {e}"))
        self._rounds += 1
        logger.info("served %d clips in %.1f ms", len(gathered),
                    (time.perf_counter() - t0) * 1e3)
        if self._rounds % self.stats_every == 0:
            logger.info("serving stats: %s", self.stats())

    def serve(self, requests: Iterable[Request], emit: Callable[[Response], None]):
        """Serve until ``requests`` is exhausted; blocks the calling thread.

        One round is in flight: round k's device work runs while round k+1
        gathers and decodes. When the queue goes idle the round in flight is
        finished at once, so light traffic never waits on a later round.
        Under a plan this is rank 0's loop: it leads the followers' rounds
        and ends them when ``requests`` is exhausted."""
        if self.plan is not None and self.plan.rank != 0:
            raise RuntimeError("serve runs on rank 0; the other ranks call follow()")
        q: queue.Queue = queue.Queue()  # (arrival, request)

        def reader():
            try:
                for r in requests:
                    q.put((time.perf_counter(), r))
            finally:
                q.put((time.perf_counter(), _STOP))

        t = threading.Thread(target=reader, daemon=True)
        t.start()

        done = False
        in_flight = None  # (work, gathered, tracked_emit, emitted, t0, round)
        round_no = 0
        while not done:
            if in_flight is not None:
                try:
                    arrival, first = q.get_nowait()
                except queue.Empty:
                    # idle queue: answer the round in flight now
                    self._finish_pending(in_flight)
                    in_flight = None
                    continue
            else:
                with span("serve.idle"):
                    arrival, first = self._next_request(q)
            if first is _STOP:
                break
            round_no += 1
            with span("serve.round", round=round_no) as this_round:
                with span("serve.gather", round=round_no):
                    arrivals = {first.req_id: arrival}
                    gathered = [first]
                    deadline = time.perf_counter() + self.max_wait_s
                    while len(gathered) < self.max_clips:
                        timeout = deadline - time.perf_counter()
                        if timeout <= 0:
                            break
                        try:
                            arrival, nxt = q.get(timeout=timeout)
                        except queue.Empty:
                            break
                        if nxt is _STOP:
                            done = True
                            break
                        arrivals[nxt.req_id] = arrival
                        gathered.append(nxt)
                this_round.set(clips=len(gathered))
                t0 = time.perf_counter()
                for r in gathered:
                    record("serve.wait", arrivals[r.req_id], t0, req_id=r.req_id,
                           round=round_no)

                def tracked_emit(resp: Response, _arr=arrivals, _t0=t0):
                    self._latencies.append(time.perf_counter() - _arr.get(resp.req_id, _t0))
                    if resp.ok:
                        self._served += 1
                    else:
                        self._failed += 1
                    emit(resp)

                emitted: set[str] = set()
                try:
                    work = self._submit_round(gathered)
                except Exception as e:  # noqa: BLE001
                    logger.exception("round submit failed")
                    for r in gathered:
                        tracked_emit(Response(r.req_id, r.path, False, None,
                                              f"round failed: {e}"))
                    self._rounds += 1
                    work = None
                # the new round's device work is queued: now finish the
                # previous round, whose device time overlapped this gather
                # and decode
                if in_flight is not None:
                    self._finish_pending(in_flight)
                    in_flight = None
                if work is not None:
                    in_flight = (work, gathered, tracked_emit, emitted, t0, round_no)
        if in_flight is not None:
            self._finish_pending(in_flight)
        self._send("stop")
        t.join(timeout=1.0)

    def _next_request(self, q: queue.Queue):
        """Wait for the next (arrival, request); under a plan, tell the
        followers every ``idle_interval_s()`` that the leader is idle."""
        if self.plan is None:
            return q.get()
        while True:
            try:
                return q.get(timeout=idle_interval_s())
            except queue.Empty:
                self._send("idle")

    # -- the other ranks of a plan -----------------------------------------

    def follow(self) -> None:
        """A follower's loop (a rank other than 0 of the plan): take part in
        rank 0's rounds until it sends "stop". On "round" submit this rank's
        rows of each bucket batch, in rank 0's order; on "finish" collect and
        gather the oldest round in flight, then its long clips, as rank 0
        finishes them."""
        if self.plan is None or self.plan.rank == 0:
            raise RuntimeError("follow runs on the ranks other than 0 of a plan")
        in_flight: deque = deque()
        while True:
            op, *args = broadcast_round(self.plan)
            if op == "round":
                batches, long_paths = args
                in_flight.append(([self._submit_batch(b, paths) for b, paths in batches],
                                  long_paths))
            elif op == "finish":
                self._finish_following(*in_flight.popleft())
            elif op == "stop":
                return
            # "idle": rank 0 is waiting for traffic

    def _finish_following(self, pending: list, long_paths: list[str]) -> None:
        """A follower's part of ``_finish_round``: the same collectives, in
        the same order; rank 0 reports every failure."""
        for submitted in pending:
            try:
                collect_rows(self.extractor, submitted)
            except Exception:  # noqa: BLE001 — rank 0 fails the batch's requests
                logger.exception("batch failed on this rank")
        for path in long_paths:
            try:
                chunked_embeddings(self.extractor, self.batcher, path)
            except Exception:  # noqa: BLE001 — rank 0 fails the request
                logger.exception("chunked extraction failed for %s on this rank", path)


def jsonl_requests(lines: Iterable[str]) -> Iterator[Request]:
    """JSONL requests: ``{"id": ..., "path": ...}`` (id optional, the line
    number by default); a line that is not such an object is a bare path."""
    for n, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
            yield Request(str(obj.get("id", n)), obj["path"])
        except (ValueError, KeyError, TypeError, AttributeError):
            yield Request(str(n), line)
