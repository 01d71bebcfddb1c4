"""Serving cells: ``EmbeddingServer.serve`` as ``cli/serve.py`` builds it in
its JSONL mode, fed by an open loop of paced requests.

Set-up writes a pool of clips, makes the model and its weights on the card
from the seed, and serves one full batch of each length bucket the pool
uses, unpaced. The window then sends requests at the mix's fixed rate
(Poisson arrivals, each a clip of the pool) for ``--seconds``, and waits
until the server has answered every one. Every seed sends the same gaps
and the same clips, in another order. Each request's latency runs from when
it was due to its response; a request that fails, or that is never
answered, counts with the time it waited until the run ended. A traced run
profiles a further stretch of paced requests after the window.

``correct``: every request answered, and a sample of the answers, drawn
from the seed, held to the family's float32 reference by the worst cosine
distance of each group of columns.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.corpus import read_wav, write_corpus
from benchmark.entries.extract import cosine_distance
from benchmark.trace import Spans, profiled


def schedule(traffic: dict, seconds: float, seed: int) -> list[tuple[float, int]]:
    """(due second, pool index) of every request: rate x seconds requests,
    their gaps the exponential distribution's evenly spaced quantiles and
    their clips each pool clip in turn, both in the seed's order."""
    rng = np.random.default_rng(seed)
    rate, pool = float(traffic["rate_per_s"]), int(traffic["clips"])
    n = max(1, int(round(rate * seconds)))
    gaps = rng.permutation(-np.log1p(-(np.arange(n) + 0.5) / n) / rate)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return list(zip(due.tolist(), rng.permutation(np.arange(n) % pool).tolist()))


class OpenLoop:
    """Requests sent at their due times; answers timed as they come."""

    def __init__(self, paths: list[str], plan: list[tuple[float, int]], keep: set[str]):
        self.paths, self.plan, self.keep = paths, plan, keep
        self.answers: dict[str, tuple[float, bool, dict | None]] = {}
        self.lag_s = 0.0
        self.start = 0.0

    def requests(self):
        from stutter_tpu_torch.serve.server import Request

        self.start = time.perf_counter() + 0.05
        for k, (due, idx) in enumerate(self.plan):
            wait = self.start + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            else:
                self.lag_s = max(self.lag_s, -wait)
            yield Request(str(k), self.paths[idx])

    def emit(self, resp) -> None:
        self.answers[resp.req_id] = (time.perf_counter(), resp.ok,
                                     resp.embeddings if resp.req_id in self.keep else None)

    def latencies(self, end: float) -> np.ndarray:
        """Seconds from due to answer; a failed or missing one to ``end``."""
        out = []
        for k, (due, _) in enumerate(self.plan):
            t, ok, _ = self.answers.get(str(k), (end, False, None))
            out.append((t if ok else end) - (self.start + due))
        return np.asarray(out)


def run(ctx) -> dict:
    from stutter_tpu_torch.extract.batcher import DEFAULT_BUCKETS_S, BucketBatcher
    from stutter_tpu_torch.serve.server import EmbeddingServer, Request

    traffic, family, server_cfg = ctx.traffic, ctx.family, ctx.traffic["server"]
    marks = {"start": time.perf_counter()}
    pool = write_corpus(ctx.workdir / "pool", traffic, ctx.seed)
    paths = sorted(pool)
    marks["corpus"] = time.perf_counter()
    model, weights = family.build(ctx.config, ctx.seed, ctx.device)
    extractor = family.extractor(model, ctx.device, ctx.preset)
    del model
    max_clips = int(server_cfg["max_clips"])
    batcher = BucketBatcher(buckets_s=DEFAULT_BUCKETS_S, audio_budget_s=max_clips * 3.0,
                            max_batch=max_clips, frame_align=extractor.frame_align)
    server = EmbeddingServer(extractor, batcher, max_wait_s=server_cfg["max_wait_ms"] / 1e3,
                             max_clips=max_clips, long_clip_policy=server_cfg["long_clip_policy"])
    ctx.sync()
    marks["model"] = time.perf_counter()
    by_bucket = batcher.assign_buckets(paths)
    warm = [Request(f"warm{b}-{i}", paths[i]) for b, idx in by_bucket.items()
            for i in idx[: batcher.batch_size_for(b)]]
    server.serve(warm, lambda resp: None)
    ctx.sync()
    server.reset_stats()
    marks["warm"] = time.perf_counter()

    plan = schedule(traffic, ctx.seconds, ctx.seed)
    rng = np.random.default_rng(ctx.seed)
    sample = {str(k) for k in rng.choice(len(plan), size=min(len(plan),
                                         int(ctx.config["check"]["clips"])), replace=False)}
    loop = OpenLoop(paths, plan, sample)
    spans = Spans()
    if ctx.trace:
        extractor.submit = spans.wrap("submit", extractor.submit)
    ctx.window_started()
    server.serve(loop.requests(), loop.emit)
    end = time.perf_counter()
    stats = server.stats()
    latencies = loop.latencies(end)
    answered = sum(1 for _, ok, _ in loop.answers.values() if ok)
    record = {"latencies_s": latencies, "stats": stats, "spans": dict(spans.seconds),
              "span_calls": dict(spans.calls), "attempted": len(plan),
              "failed": len(plan) - answered, "weights": weights, "loop": loop,
              "paths": paths, "plan": plan,
              "notes": {"setup_parts_s": {k: round(marks[k] - marks[j], 3) for j, k in
                                          zip(marks, list(marks)[1:])},
                        "before_entry_s": round(marks["start"] - ctx.started, 3),
                        "requests": len(plan), "rate_per_s": traffic["rate_per_s"],
                        "answered_per_s": answered / (end - loop.start),
                        "generator_lag_s": round(loop.lag_s, 4),
                        "last_latency_s": round(float(latencies[-1]), 4),
                        "p50_ms": round(1e3 * float(np.percentile(latencies, 50)), 3),
                        "wall_s": round(end - loop.start, 3), "server": stats}}
    if ctx.trace:
        extra = OpenLoop(paths, schedule(traffic, traffic.get("traced_seconds", 4.0),
                                         ctx.seed + 1), set())
        with profiled(record):
            server.serve(extra.requests(), extra.emit)
        del extractor.submit
    del server, extractor
    return record


def check(ctx, record) -> dict[str, float]:
    """The requests left unanswered, and each column group's worst cosine
    distance from the reference over the sampled answers."""
    loop, family, config = record["loop"], ctx.family, ctx.config
    kept = sorted(((k, emb) for k, (_, ok, emb) in loop.answers.items()
                   if ok and emb is not None), key=lambda x: int(x[0]))
    paths = [record["paths"][record["plan"][int(k)][1]] for k, _ in kept]
    ref = family.reference_rows(config, record["weights"], [read_wav(p) for p in paths],
                                ctx.device)
    numbers = {"unanswered": float(record["failed"])}
    for group, cols in family.column_groups(config).items():
        numbers[f"{group}_cos_dist"] = max((cosine_distance(emb[c], want[c])
                                            for (_, emb), want in zip(kept, ref) for c in cols),
                                           default=0.0)
    return numbers
