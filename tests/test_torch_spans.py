"""The port's span recorder (``utils/profiling.py``) and the spans the
extraction loop, the server and the trainer open, on the CPU.

The recorder is off by default and then records nothing; on, it keeps
parent ids per thread, and a run writes the same store, bit for bit, with
it on and off. The server's ``serve.wait`` spans and its ``stats()`` time
each request from the reader's enqueue. Under ``utils.profiling.trace`` the
spans of the profiling thread are ranges of the Chrome trace, nested as
their parent ids say.
"""

import dataclasses
import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from stutter_tpu_torch.audio.synthetic import make_synthetic_corpus
from stutter_tpu_torch.extract.batcher import BucketBatcher
from stutter_tpu_torch.extract.checkpoint import find_latest_checkpoint, load_checkpoint
from stutter_tpu_torch.extract.pipeline import ExtractionPipeline, WavLMExtractor
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.serve.server import EmbeddingServer, Request
from stutter_tpu_torch.train.finetune import FinetuneConfig, FinetuneTrainer
from stutter_tpu_torch.utils import profiling as prof

torch.set_num_threads(2)  # six xdist workers share the host


@pytest.fixture
def recording():
    """The process's recorder on and empty; off and empty afterwards."""
    prof.reset()
    prof.enable()
    yield prof
    prof.disable()
    prof.reset()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spans_corpus"))
    # sized in frames for the tiny 20x stem
    make_synthetic_corpus(root, n_per_split={"train": 11}, duration_range=(0.3, 1.8))
    return root


@pytest.fixture(scope="module")
def extractor():
    torch.manual_seed(0)
    return WavLMExtractor(WavLMModel(WavLMConfig.tiny()), "cpu", preset="fidelity")


def _batcher(ex, **kw):
    return BucketBatcher(frame_align=ex.frame_align,
                         **dict(dict(buckets_s=(1.0, 2.0), audio_budget_s=4.0), **kw))


def _named(records, name):
    return [r for r in records if r.name == name]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


def test_span_off_is_one_shared_noop_that_records_nothing():
    prof.disable()
    prof.reset()
    first, second = prof.span("extract.submit", batch=0), prof.span("serve.round")
    assert first is second
    with first as s:
        s.set(rows=3)
    prof.record("serve.wait", 1.0, 2.0, req_id="a")
    with prof.timed("serve.collect_wait") as waited:  # times, but keeps nothing
        time.sleep(0.002)
    assert waited.seconds >= 0.002
    assert prof.records() == [] and prof.RECORDER.dropped == 0


def test_nested_spans_carry_parent_ids_and_attributes(recording):
    with prof.span("a", batch=1) as a:
        with prof.span("b") as b:
            with prof.span("c") as c:
                pass
        with prof.span("d") as d:
            d.set(rows=5)
    got = prof.records()
    assert [r.name for r in got] == ["c", "b", "d", "a"]  # in the order they end
    assert (a.parent, b.parent, c.parent, d.parent) == (None, a.id, b.id, a.id)
    assert len({a.id, b.id, c.id, d.id}) == 4
    assert a.attrs == {"batch": 1} and d.attrs == {"rows": 5}
    me = threading.get_native_id()
    for r in got:
        assert r.thread == me and not r.profiled and r.start <= r.end
    assert a.start <= b.start <= c.start <= c.end <= b.end <= d.start <= d.end <= a.end


def test_each_thread_keeps_its_own_parents(recording):
    seen = {}

    def worker():
        with prof.span("worker.outer") as outer:
            with prof.span("worker.inner") as inner:
                seen.update(outer=outer, inner=inner, thread=threading.get_native_id())

    with prof.span("main") as main:
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["outer"].parent is None  # not the main thread's open span
    assert seen["inner"].parent == seen["outer"].id
    assert seen["thread"] != main.thread == threading.get_native_id()
    assert {seen["outer"].thread, seen["inner"].thread} == {seen["thread"]}


def test_stage_timer_keeps_each_stage_as_a_span_and_counts_drops():
    timer = prof.StageTimer(cap=3)
    for name in ("decode", "forward", "forward", "store"):
        with timer.stage(name, clips=2):
            pass
    kept = timer.record("wait", 10.0, 10.5, req_id="r1")
    assert [s.name for s in timer.spans] == ["decode", "forward", "forward"]
    assert timer.dropped == 2 and timer.counts["store"] == 1 and timer.counts["wait"] == 1
    assert timer.totals["forward"] == sum(s.seconds for s in timer.spans if s.name == "forward")
    assert kept.parent is None and kept.seconds == 0.5 and kept.attrs == {"req_id": "r1"}
    timer.reset()
    assert timer.spans == [] and timer.dropped == 0 and dict(timer.totals) == {}


def test_prefetch_thread_spans_carry_their_own_thread(recording, corpus, extractor):
    paths = [r["path"] for r in create_metadata_from_files(corpus, "train")]
    batches = list(_batcher(extractor).batches(paths))
    got = prof.records()
    me = threading.get_native_id()
    plan, = _named(got, "extract.plan")
    decodes, waits = _named(got, "extract.decode"), _named(got, "extract.decode_wait")
    assert plan.thread == me and plan.attrs == {"files": len(paths)}
    assert len(batches) > 1 and len(decodes) == len(waits) == len(batches)
    assert {d.thread for d in decodes} != {me} and me not in {d.thread for d in decodes}
    assert {w.thread for w in waits} == {me}
    assert sorted(d.attrs["batch"] for d in decodes) == [w.attrs["batch"] for w in waits] \
        == list(range(len(batches)))
    assert sum(d.attrs["clips"] for d in decodes) == len(paths)
    assert all(d.attrs["failed"] == 0 and d.parent is None for d in decodes)


# ---------------------------------------------------------------------------
# the extraction loop
# ---------------------------------------------------------------------------


def _store_bytes(out: str) -> dict[str, bytes]:
    files = sorted(glob.glob(os.path.join(out, "train", "*")))
    assert files
    return {os.path.basename(f): open(f, "rb").read() for f in files}


def test_run_split_writes_the_same_store_and_records_each_batch(corpus, extractor,
                                                                tmp_path):
    meta = create_metadata_from_files(corpus)
    prof.disable()
    prof.reset()
    ExtractionPipeline(extractor, batcher=_batcher(extractor), checkpoint_interval=3
                       ).run_split(meta, "train", str(tmp_path / "off"))
    assert prof.records() == []
    prof.enable()
    try:
        ExtractionPipeline(extractor, batcher=_batcher(extractor), checkpoint_interval=3
                           ).run_split(meta, "train", str(tmp_path / "on"))
        got = prof.records()
    finally:
        prof.disable()
        prof.reset()
    assert _store_bytes(str(tmp_path / "on")) == _store_bytes(str(tmp_path / "off"))

    n_batches = len(_named(got, "extract.decode"))
    submits = _named(got, "extract.submit")
    assert n_batches > 1 and len(submits) == len(_named(got, "extract.collect_wait")) \
        == len(_named(got, "extract.rows")) == n_batches
    for name in ("extract.pin", "extract.encode"):
        assert sorted(r.parent for r in _named(got, name)) == sorted(s.id for s in submits)
    assert sum(s.attrs["clips"] for s in submits) == 11
    # a checkpoint after each batch that brings 3 rows or more since the last
    expected, since, done = [], 0, 0
    for rows in _named(got, "extract.rows"):
        since, done = since + rows.attrs["rows"], done + rows.attrs["rows"]
        if since >= 3:
            expected.append(done)
            since = 0
    checkpoints = _named(got, "extract.checkpoint")
    assert [c.attrs["rows"] for c in checkpoints] == expected and expected
    assert [c.attrs["checkpoint"] for c in checkpoints] == list(range(1, len(expected) + 1))
    out = str(tmp_path / "on")
    assert find_latest_checkpoint(out, "train") == len(expected)
    assert [len(load_checkpoint(out, "train", c.attrs["checkpoint"]))
            for c in checkpoints] == expected
    store, = _named(got, "extract.store")
    assert store.attrs == {"rows": 11}


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


class _SlowExtractor:
    """Enqueues nothing: ``submit`` takes ``delay`` seconds, ``collect``
    returns zero rows, so that requests queue behind a round."""

    column_names = ["layer_1"]

    def __init__(self, delay: float):
        self.delay = delay

    def submit(self, batch):
        time.sleep(self.delay)
        return len(batch.waves)

    def collect(self, handle):
        return {"layer_1": np.zeros((handle, 4), np.float32)}


def test_server_times_each_request_from_the_readers_enqueue(recording, corpus, extractor):
    paths = [r["path"] for r in create_metadata_from_files(corpus, "train")][:6]
    yielded, answered = {}, {}

    def requests():
        for i, p in enumerate(paths):
            yielded[f"r{i}"] = time.perf_counter()
            yield Request(f"r{i}", p)

    def emit(resp):
        answered[resp.req_id] = time.perf_counter()

    server = EmbeddingServer(_SlowExtractor(0.15), _batcher(extractor), max_wait_s=0.02,
                             max_clips=2)
    server.serve(requests(), emit)
    got = prof.records()
    waits = {w.attrs["req_id"]: w for w in _named(got, "serve.wait")}
    rounds = {r.attrs["round"]: r for r in _named(got, "serve.round")}
    assert sorted(waits) == sorted(yielded) == sorted(answered)
    order = sorted(yielded, key=yielded.get)
    for k, req in enumerate(order):
        w = waits[req]
        # stamped by the reader after the source yields it, before the next
        assert yielded[req] <= w.start <= w.end
        if k + 1 < len(order):
            assert w.start <= yielded[order[k + 1]]
        r = rounds[w.attrs["round"]]
        assert r.start <= w.end <= r.end and w.parent is None
    assert len(rounds) >= 3 and sum(r.attrs["clips"] for r in rounds.values()) == 6
    for name in ("serve.gather", "serve.probe", "serve.decode", "serve.submit"):
        assert {s.parent for s in _named(got, name)} <= {r.id for r in rounds.values()}
    # stats() from the same arrival: the later rounds' requests waited in the queue
    s = server.stats()
    from_arrival = [answered[q] - waits[q].start for q in order]
    assert s["max_s"] == pytest.approx(max(from_arrival), abs=5e-3)
    assert s["max_s"] >= 0.3  # two rounds of 0.15 s queued ahead of the last
    collected = _named(got, "serve.collect_wait") + _named(got, "serve.chunked")
    assert len(_named(got, "serve.collect_wait")) == len(_named(got, "serve.decode"))
    assert s["device_collect_s"] == round(sum(c.seconds for c in collected), 3)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _batch(rng, b=3, n=3200):
    waves = (rng.randn(b, n) * 0.1).astype(np.float32)
    lengths = np.full((b,), n, np.int32)
    lengths[1] = n // 2
    labels = rng.randint(0, 3, size=b).astype(np.int32)
    valid = np.array([1.0, 1.0, 0.0], np.float32)
    return waves, lengths, labels, valid


def test_step_and_step_accum_record_one_forward_and_backward_a_microbatch(recording):
    rng = np.random.RandomState(0)
    mcfg = dataclasses.replace(WavLMConfig.tiny(32, 2, 4), apply_spec_augment=False)
    cfg = FinetuneConfig(model=mcfg, n_classes=3, head_hidden=(8,), head_dropout=0.0,
                         activation_dtype=torch.float32)
    cw = np.ones(3, np.float32)
    trainer = FinetuneTrainer(cfg, device="cpu", grad_accum=3)
    waves, lengths, labels, valid = _batch(rng)
    trainer.step(waves, lengths, labels, cw, valid=valid)
    trainer.step_accum([_batch(rng), _batch(rng)], cw, sync=False)  # padded to 3
    got = prof.records()
    steps = _named(got, "finetune.step")
    assert [s.attrs["update"] for s in steps] == [1, 2]
    first, second = (s.id for s in steps)
    for name, counts in (("finetune.h2d", (1, 1)), ("finetune.forward", (1, 3)),
                         ("finetune.backward", (1, 3)), ("finetune.optim", (1, 1)),
                         ("finetune.sync", (1, 0))):
        parents = [r.parent for r in _named(got, name)]
        assert (parents.count(first), parents.count(second)) == counts, name
    assert [r.attrs["microbatch"] for r in _named(got, "finetune.forward")] == [0, 0, 1, 2]
    for fwd, bwd in zip(_named(got, "finetune.forward"), _named(got, "finetune.backward")):
        assert fwd.end <= bwd.start


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------


def test_chrome_trace_holds_the_spans_nested_as_recorded(recording, corpus, extractor,
                                                         tmp_path):
    meta = create_metadata_from_files(corpus)
    with prof.trace(str(tmp_path / "trace")):
        with prof.span("outer"):
            ExtractionPipeline(extractor, batcher=_batcher(extractor), checkpoint_interval=3
                               ).run_split(meta, "train", str(tmp_path / "out"))
    path, = glob.glob(str(tmp_path / "trace" / "*.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    me = threading.get_native_id()
    mine = [r for r in prof.records() if r.thread == me]
    assert all(r.profiled for r in prof.records())
    assert {r.name for r in mine} >= {"outer", "extract.plan", "extract.decode_wait",
                                      "extract.submit", "extract.pin", "extract.encode",
                                      "extract.collect_wait", "extract.rows",
                                      "extract.checkpoint", "extract.store"}
    # the k-th span of a name is the k-th range of that name
    ranges = {}
    for name in {r.name for r in mine}:
        spans = sorted((r for r in mine if r.name == name), key=lambda r: r.start)
        found = sorted((e for e in events if e["name"] == name), key=lambda e: e["ts"])
        assert len(found) == len(spans), name
        ranges.update({s.id: (e["ts"], e["ts"] + e["dur"]) for s, e in zip(spans, found)})
    by_id = {r.id: r for r in mine}
    for r in mine:
        if r.parent is not None:
            (a, b), (pa, pb) = ranges[r.id], ranges[r.parent]
            assert pa <= a and b <= pb, (r.name, by_id[r.parent].name)
    # one clock: the ranges start in the order the spans do
    starts = [ranges[r.id][0] for r in sorted(mine, key=lambda r: r.start)]
    assert starts == sorted(starts)
