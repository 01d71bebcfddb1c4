"""Extraction cells: ``ExtractionPipeline.run_split`` over one split, pass
after pass, as the family's extraction CLI builds the pipeline.

Set-up writes the corpus, makes the model and its weights on the device
from the seed, and runs one pass over the first two batches of the split
(the kernels, cuDNN, the decoder threads, the store). The window then runs
whole passes over the split into one output directory until ``--seconds``
have gone by, and ends with the pass in which they ran out. Where
``ctx.profile_window`` is set, the device's work over the whole window is
recorded (kernels and copies only, the profiler started in set-up); a
traced run leaves the window alone and profiles one more pass after it.

``correct``: a sample of the split's clips, drawn from the seed, is run
through the family's plain float32 reference, and each clip's row in every
pass of the window, and in the store on disk after the last pass, is held
to it by the worst cosine distance of each group of columns; every clip of
the split has to be in every pass and in the store.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path

import numpy as np

from benchmark.corpus import read_wav, write_corpus
from benchmark.trace import Spans, device_profiled, profiled

CHECKPOINT_INTERVAL = 50  # the extraction CLIs' default


def instrument(pipe, spans: Spans):
    """Spans around the batcher's ``next`` (decode), ``submit`` (the model
    step's enqueue) and the store's and checkpoints' writes; returns the
    function that undoes them."""
    from stutter_tpu_torch.extract import pipeline as module

    saved = {name: getattr(module, name) for name in ("save_checkpoint", "save_embeddings")}
    module.save_checkpoint = spans.wrap("store", saved["save_checkpoint"])
    module.save_embeddings = spans.wrap("store", saved["save_embeddings"])
    pipe.batcher.batches = spans.wrap_iter("decode", pipe.batcher.batches)
    pipe.extractor.submit = spans.wrap("submit", pipe.extractor.submit)

    def undo():
        for name, fn in saved.items():
            setattr(module, name, fn)
        del pipe.batcher.batches
    return undo


def launches() -> dict[str, int]:
    from stutter_tpu_torch.ops.flash_mha import flash_mha
    from stutter_tpu_torch.ops.wavlm_attention import gated_relpos_attention

    return {"gated_attn_fwd": gated_relpos_attention.launches,
            "flash_mha": flash_mha.launches}


def run(ctx) -> dict:
    from stutter_tpu_torch.extract.pipeline import ExtractionPipeline
    from stutter_tpu_torch.extract.scanner import create_metadata_from_files

    traffic, family, split = ctx.traffic, ctx.family, ctx.traffic.get("split", "train")
    sr = float(traffic.get("sample_rate", 16000))
    corpus = ctx.workdir / "corpus"
    marks = {"start": time.perf_counter()}
    clips = write_corpus(corpus, traffic, ctx.seed)
    marks["corpus"] = time.perf_counter()
    model, weights = family.build(ctx.config, ctx.seed, ctx.device)
    extractor = family.extractor(model, ctx.device, ctx.preset)
    del model
    ctx.sync()
    marks["model"] = time.perf_counter()
    pipe = ExtractionPipeline(extractor, batcher=family.batcher(extractor, ctx.config),
                              checkpoint_interval=CHECKPOINT_INTERVAL)
    meta = create_metadata_from_files(str(corpus), split=split)
    if len(meta) != len(clips):
        raise RuntimeError(f"the scanner found {len(meta)} of {len(clips)} clips")
    batch = pipe.batcher.batch_size_for(pipe.batcher.buckets_s[-1])
    pipe.run_split(meta[: 2 * batch], split, str(ctx.workdir / "warm"))
    ctx.sync()
    marks["warm"] = time.perf_counter()

    spans = Spans()
    shapes: list[tuple[int, int]] = []
    submit = extractor.submit

    def recorded(batch):
        shapes.append(tuple(batch.waves.shape))
        return submit(batch)

    extractor.submit = recorded
    undo = instrument(pipe, spans) if ctx.trace else (lambda: None)
    out = ctx.workdir / "store"
    sample = set(sample_paths(clips, ctx.config, ctx.seed))
    passes = []
    window: dict = {}
    with device_profiled(window, on=ctx.profile_window):
        ctx.window_started()
        start = time.perf_counter()
        while not passes or time.perf_counter() - start < ctx.seconds:
            t0, cpu0, spans0 = time.perf_counter(), time.process_time(), dict(spans.seconds)
            rows = pipe.run_split(meta, split, str(out))
            ctx.sync()
            wall = time.perf_counter() - t0
            paths = [r["path"] for r in rows]
            passes.append({"wall_s": wall, "paths": paths, "cpu_s": time.process_time() - cpu0,
                           "spans": {k: v - spans0.get(k, 0.0)
                                     for k, v in spans.seconds.items()},
                           "audio_s": sum(clips[p] for p in paths) / sr,
                           "n_clips": len(paths),
                           "sampled": {r["path"]: r for r in rows if r["path"] in sample}})
    attempted = len(clips) * len(passes)
    record = {"passes": passes, "spans": dict(spans.seconds), "attempted": attempted,
              "failed": attempted - sum(len(set(p["paths"]) & set(clips)) for p in passes),
              "batches": list(shapes), "clips": clips, "weights": weights, "store": out,
              "split": split, "window_trace": window.get("trace"), "notes": {
                  "setup_parts_s": {k: round(marks[k] - marks[j], 3) for j, k in
                                    zip(marks, list(marks)[1:])},
                  "before_entry_s": round(marks["start"] - ctx.started, 3),
                  "pass_s": [round(p["wall_s"], 4) for p in passes],
                  "pass_cpu_s": [round(p["cpu_s"], 4) for p in passes],
                  "pass_spans": [{k: round(v, 4) for k, v in p["spans"].items()}
                                 for p in passes]}}
    if "trace" in window:
        record["notes"]["window_busy_s"] = window["trace"].busy_s
    if ctx.trace:
        shapes.clear()
        before = launches()
        with profiled(record):
            pipe.run_split(meta, split, str(ctx.workdir / "traced"))
        record["trace_batches"] = list(shapes)
        record["trace_launches"] = {k: v - before[k] for k, v in launches().items()}
    undo()
    del extractor.submit, pipe, extractor
    return record


def read_store(out: Path, split: str) -> dict[str, dict[str, np.ndarray]]:
    """{path: {column: row}} of the store that the last pass wrote."""
    folder = out / split
    with open(folder / "embedding_metadata.csv", newline="") as f:
        paths = [r["path"] for r in csv.DictReader(f)]
    cols = {p.name[: -len("_embeddings.npy")]: np.load(p)
            for p in folder.glob("*_embeddings.npy")}
    return {path: {c: a[i] for c, a in cols.items()} for i, path in enumerate(paths)}


def cosine_distance(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return 1.0 - float(a @ b / denom) if denom > 0 else float("inf")


def sample_paths(clips: dict, config: dict, seed: int) -> list[str]:
    """The clips the check compares: ``config["check"]["clips"]`` of them,
    drawn from the seed."""
    paths = sorted(clips)
    n = min(len(paths), int(config["check"]["clips"]))
    return [paths[i] for i in sorted(np.random.default_rng(seed).choice(
        len(paths), size=n, replace=False))]


def check(ctx, record) -> dict[str, float]:
    """The numbers that decide ``correct``, by name: the rows missing from
    the passes and the store, and each column group's worst cosine distance
    from the reference over the sample, every pass and the store."""
    family, config, clips = ctx.family, ctx.config, record["clips"]
    sample = sample_paths(clips, config, ctx.seed)
    store = read_store(record["store"], record["split"])
    answers = [p["sampled"] for p in record["passes"]] + [store]
    missing = record["failed"] + len(set(clips) - set(store))
    waves = [read_wav(p) for p in sample]
    ref = family.reference_rows(config, record["weights"], waves, ctx.device)
    numbers = {"missing_rows": float(missing)}
    for group, cols in family.column_groups(config).items():
        numbers[f"{group}_cos_dist"] = max((
            cosine_distance(got[path][c], want[c])
            for path, want in zip(sample, ref) for got in answers if path in got
            for c in cols), default=0.0)
    return numbers
