"""Serving, batch prediction and the downstream trainers on two gloo ranks (CPU).

The two-rank ``EmbeddingServer`` (rank 0 leads, rank 1 follows) at DP = 2
and TP = 2 against the JAX ``EmbeddingServer`` on a two-device mesh of the
virtual CPU devices ``tests/conftest.py`` gives, with the same numpy
weights: rows within 1e-5 cosine (f32), each request answered once, a long
clip chunked, an undecodable file failing alone; the HTTP frontend on rank
0; a follower that idles longer than its group's timeout. Then the CLIs
with ``--devices 2 --device cpu`` against one process: ``cli.serve`` over
JSONL (WavLM and combined), ``cli.predict``, ``cli.train`` and
``cli.train_grid`` with augmentation (rank 1 writes no file). Last, the
batch multiple of ``make_bucket_batcher`` and the padding of
``_embed_waves`` against the JAX functions. Ranks are processes of their
own (``tests/test_torch_distributed.py``'s ``run_bounded``), meeting
through a ``FileStore`` under ``tmp_path``, that import torch and the port
only (the JAX package is imported inside the tests); the CLI ranks load
tiny HF checkpoints, since they cannot see a monkeypatched config.
"""

import builtins
import dataclasses
import datetime
import glob
import json
import os
import pickle
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stutter_tpu_torch.audio.wavio import load_audio, write_wav
from stutter_tpu_torch.cli import common
from stutter_tpu_torch.cli import predict as predict_cli
from stutter_tpu_torch.cli import serve as serve_cli
from stutter_tpu_torch.extract.batcher import BucketBatcher
from stutter_tpu_torch.extract.pipeline import WavLMExtractor
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.parallel import mesh
from stutter_tpu_torch.serve.http import HttpEmbeddingFrontend
from stutter_tpu_torch.serve.server import EmbeddingServer, Request
from stutter_tpu_torch.train import augment_extract as ae
from stutter_tpu_torch.weights.convert import wavlm_params_from_numpy
from tests.test_torch_distributed import REPO, _cosine as cosine_distance, run_bounded

torch.set_num_threads(2)  # six xdist workers share the host

COSINE = 1e-5  # f32 on the CPU: another batch split or model cut of the same products
BUCKETS = (0.5, 1.0)  # tiny 20x stem: a 1 s bucket is 800 frames
LONG_S = 2.3  # over the top bucket: three chunks
IDLE_TIMEOUT_S = 1.5  # the follower's group timeout in the idle test


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------


def _run_ranks(tmp_path, fn: str, **kw) -> None:
    """``fn(**kw)`` of this module on two gloo ranks (processes)."""
    args = (str(tmp_path / "dist_store"), fn, json.dumps(kw))
    code = (f"import sys; sys.path[:0] = {[os.path.join(REPO, 'tests'), REPO]!r}; "
            "import test_torch_parallel_serve as t; t._rank_main(%d, *%r)")
    run_bounded([[sys.executable, "-c", code % (r, args)] for r in range(2)])


def _rank_main(rank: int, store: str, fn: str, kw: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    try:
        globals()[fn](**json.loads(kw))
    finally:
        dist.destroy_process_group()


def _extractor(state: str, plan):
    model = WavLMModel(WavLMConfig.tiny(), device="meta").to_empty(device="cpu")
    model.load_state_dict(torch.load(state))
    return WavLMExtractor(model, "cpu", preset="fidelity", plan=plan)


def _server(extractor, data: int) -> EmbeddingServer:
    return EmbeddingServer(extractor, batcher=BucketBatcher(
        buckets_s=BUCKETS, audio_budget_s=4.0, max_batch=4, batch_multiple=data),
        max_wait_s=0.01, max_clips=4, long_clip_policy="chunk")


def _answers(responses) -> list:
    return [(r.req_id, r.ok, r.error, r.embeddings) for r in responses]


def _w_server(out: str, state: str, paths: list) -> None:
    """At [2, 1] then [1, 2] rank 0 serves ``paths`` (ids r0, r1, ...) and
    rank 1 follows; at [2, 1] rank 0 then POSTs two of them (a JSON path,
    raw WAV bytes) and a missing file to the HTTP frontend."""
    got = {}
    for model in (1, 2):
        plan = mesh.make_plan(model=model)
        server = _server(_extractor(state, plan), plan.data_size)
        if plan.rank != 0:
            server.follow()
            if model == 1:
                with pytest.raises(ValueError, match="rank 0"):
                    HttpEmbeddingFrontend(server, port=0)
                server.follow()
            continue
        responses = []
        server.serve(iter([Request(f"r{i}", p) for i, p in enumerate(paths)]),
                     responses.append)
        got[model] = _answers(responses)
        if model == 1:
            got["http"], got["stats"] = _post(server, [
                (json.dumps({"path": paths[0]}).encode(), "application/json"),
                (open(paths[1], "rb").read(), "audio/wav"),
                (json.dumps({"path": out + ".missing.wav"}).encode(), "application/json")])
    if dist.get_rank() == 0:
        with open(out, "wb") as f:
            pickle.dump(got, f)


def _post(server, posts: list) -> tuple[list, dict]:
    """POST each (body, content type) to an HTTP frontend over ``server``;
    the (status, answer) pairs and /stats."""
    frontend = HttpEmbeddingFrontend(server, port=0, request_timeout_s=60)
    frontend.start()
    base = f"http://{frontend.host}:{frontend.port}"
    answers = []
    try:
        for body, ctype in posts:
            req = urllib.request.Request(base + "/embed", data=body, method="POST",
                                         headers={"Content-Type": ctype})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    answers.append((r.status, json.loads(r.read())))
            except urllib.error.HTTPError as e:
                answers.append((e.code, json.loads(e.read())))
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            return answers, json.loads(r.read())
    finally:
        frontend.shutdown()


def _w_idle(out: str, state: str, path: str) -> None:
    """The idle trap: the host group gets a timeout of IDLE_TIMEOUT_S (and
    mesh.TIMEOUT with it, from which the idle interval follows); rank 0
    answers one request, idles for 2.5 timeouts, then answers another."""
    mesh.TIMEOUT = datetime.timedelta(seconds=IDLE_TIMEOUT_S)
    plan = mesh.make_plan(data=2)
    short = dist.new_group(backend="gloo", timeout=mesh.TIMEOUT)
    plan = dataclasses.replace(plan, host_group=short)
    server = _server(_extractor(state, plan), 2)
    dist.barrier()  # both models built: from here the short timeout holds
    if plan.rank != 0:
        server.follow()
        return
    responses, first = [], threading.Event()

    def emit(r):
        responses.append(r)
        first.set()

    def requests():
        yield Request("a", path)
        first.wait(60)
        time.sleep(2.5 * IDLE_TIMEOUT_S)
        yield Request("b", path)

    server.serve(requests(), emit)
    with open(out, "w") as f:
        json.dump([(r.req_id, r.ok) for r in responses], f)


def _w_embed_waves(out: str, state: str, waves: str) -> None:
    """_embed_waves on a [2, 1] plan: each rank's batches as the extractor
    gets them, and rank 0's rows."""
    plan = mesh.make_plan(data=2)
    ex = _extractor(state, plan)
    seen, submit = [], ex.submit

    def spy(batch):
        seen.append((batch.waves, batch.lengths, batch.ok))
        return submit(batch)

    ex.submit = spy
    with np.load(waves) as z:
        rows = ae._embed_waves(ex, [z[k] for k in sorted(z.files)], chunk=3)
    with open(f"{out}.{plan.rank}", "wb") as f:
        pickle.dump({"seen": seen, "rows": rows}, f)


def _w_cli(out: str, runs: list) -> None:
    """Each (module, argv) CLI's ``main`` on this rank of the group, as under
    torchrun, its stdout into ``{out}.{i}.{rank}.out``, matplotlib hidden;
    rank 1 records every
    file it opens for writing, or directory it makes, under the results or
    output directory."""
    import contextlib
    import importlib

    rank = dist.get_rank()
    report = []
    sys.modules["matplotlib"] = None  # no plots: the trainers' CSVs are compared
    for i, (module, argv) in enumerate(runs):
        flag = next(f for f in ("--results_dir", "--output_dir") if f in argv)
        root = os.path.abspath(argv[argv.index(flag) + 1])
        written, real_open, real_makedirs = [], builtins.open, os.makedirs

        def under(path, root=root) -> bool:
            return isinstance(path, (str, os.PathLike)) and \
                os.path.abspath(path).startswith(root)

        def recording_open(file, mode="r", *a, _written=written, _open=real_open, **k):
            if under(file) and any(c in mode for c in "wax+"):
                _written.append(str(file))
            return _open(file, mode, *a, **k)

        def recording_makedirs(name, *a, _written=written, _makedirs=real_makedirs, **k):
            if under(name):
                _written.append(str(name))
            return _makedirs(name, *a, **k)

        with open(f"{out}.{i}.{rank}.out", "w") as stdout:
            if rank == 1:
                builtins.open, os.makedirs = recording_open, recording_makedirs
            try:
                with contextlib.redirect_stdout(stdout):
                    rc = importlib.import_module(module).main(argv)
            finally:
                builtins.open, os.makedirs = real_open, real_makedirs
        report.append({"rc": rc, "written": written})
    with open(f"{out}.{rank}", "w") as f:
        json.dump(report, f)


def _cli_ranks(tmp_path, runs: list) -> list:
    """``_w_cli`` on two ranks: per run, (rank reports, rank 0's stdout)."""
    out = str(tmp_path / "cli")
    _run_ranks(tmp_path, "_w_cli", out=out, runs=runs)
    reports = []
    for r in range(2):
        with open(f"{out}.{r}") as f:
            reports.append(json.load(f))
    got = []
    for i in range(len(runs)):
        with open(f"{out}.{i}.0.out") as f:
            got.append(([rep[i] for rep in reports], f.read()))
    return got


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX params, the port's state dict file) of one seeded tiny WavLM."""
    import jax

    from stutter_tpu.models import WavLMConfig as JaxConfig
    from stutter_tpu.models import init_wavlm_params

    params = jax.tree.map(np.asarray, init_wavlm_params(jax.random.key(0), JaxConfig.tiny()))
    path = str(tmp_path_factory.mktemp("weights") / "wavlm.pt")
    torch.save(wavlm_params_from_numpy(params, WavLMConfig.tiny()), path)
    return params, path


@pytest.fixture(scope="module")
def requests_(tmp_path_factory):
    """Seven clips of 0.3-0.9 s, a 2.3 s clip and an undecodable file."""
    from stutter_tpu.audio.synthetic import make_synthetic_corpus

    root = tmp_path_factory.mktemp("requests")
    make_synthetic_corpus(str(root), n_per_split={"train": 7}, duration_range=(0.3, 0.9),
                          seed=8)
    paths = sorted(glob.glob(os.path.join(str(root), "wav", "*.wav")))
    wave = load_audio(paths[0])
    long_path = str(root / "long.wav")
    write_wav(long_path, np.tile(wave, 8)[: int(LONG_S * 16000)], 16000)
    bad = root / "undecodable.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    return paths[:4] + [long_path, str(bad)] + paths[4:]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """HF checkpoint directories of a seeded tiny WavLM and Whisper, written
    as ``chip_smoke.py`` writes them (no ``transformers`` import)."""
    from pathlib import Path

    import chip_smoke as smoke
    from stutter_tpu_torch.models.whisper import WhisperConfig
    from stutter_tpu_torch.weights.convert import init_wavlm, init_whisper

    root = Path(tmp_path_factory.mktemp("ckpt"))
    cfg = WavLMConfig.tiny()
    seeded = init_wavlm(cfg, torch.Generator().manual_seed(0))
    g, v = smoke.fold_pos_conv(seeded)
    smoke.write_checkpoint(torch, root / "wavlm", cfg, smoke.wavlm_hf_state(seeded, g, v, False),
                           "safetensors", do_normalize=cfg.do_normalize)
    wcfg = WhisperConfig.tiny()
    smoke.write_checkpoint(torch, root / "whisper", wcfg, smoke.whisper_hf_state(
        init_whisper(wcfg, torch.Generator().manual_seed(0))), "safetensors")
    return str(root / "wavlm"), str(root / "whisper")


def _assert_rows_close(ours: dict, theirs: dict) -> None:
    assert list(ours) == list(theirs)
    for c in theirs:
        assert cosine_distance(np.asarray(ours[c]), np.asarray(theirs[c])) <= COSINE, c


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_two_rank_server_matches_jax(tmp_path, weights, requests_):
    """Rank 0 leads and rank 1 follows at [2, 1] (then on the HTTP frontend)
    and at [1, 2]: every request answered once, the 2.3 s clip in chunks,
    the undecodable file alone failing, rows within 1e-5 cosine of the JAX
    server on a two-device mesh of the same shape."""
    import jax

    from stutter_tpu.extract import BucketBatcher as JaxBatcher
    from stutter_tpu.extract import WavLMExtractor as JaxWavLM
    from stutter_tpu.models import WavLMConfig as JaxConfig
    from stutter_tpu.parallel.mesh import make_mesh
    from stutter_tpu.serve import EmbeddingServer as JaxServer
    from stutter_tpu.serve import Request as JaxRequest

    params, state = weights
    out = str(tmp_path / "answers.pkl")
    _run_ranks(tmp_path, "_w_server", out=out, state=state, paths=requests_)
    with open(out, "rb") as f:
        got = pickle.load(f)
    bad = f"r{next(i for i, p in enumerate(requests_) if 'undecodable' in p)}"
    for model in (1, 2):
        jmesh = make_mesh(jax.devices()[:2], data=2 // model, model=model)
        jserver = JaxServer(
            JaxWavLM(JaxConfig.tiny(), params, mesh=jmesh, preset="fidelity"),
            batcher=JaxBatcher(buckets_s=BUCKETS, audio_budget_s=4.0, max_batch=4,
                               batch_multiple=jmesh.data_size),
            max_wait_s=0.01, max_clips=4, long_clip_policy="chunk")
        theirs = []
        jserver.serve(iter([JaxRequest(f"r{i}", p) for i, p in enumerate(requests_)]),
                      theirs.append)
        theirs = {r.req_id: r for r in theirs}
        ids = [a[0] for a in got[model]]
        assert sorted(ids) == sorted(theirs) == sorted(f"r{i}" for i in range(len(requests_)))
        for req_id, ok, error, rows in got[model]:
            assert ok == theirs[req_id].ok == (req_id != bad), (model, req_id, error)
            if ok:
                _assert_rows_close(rows, theirs[req_id].embeddings)
        if model == 1:
            (s0, a0), (s1, a1), (s2, a2) = got["http"]
            assert (s0, s1, s2) == (200, 200, 422) and not a2["ok"]
            _assert_rows_close(a0["embeddings"], theirs["r0"].embeddings)
            _assert_rows_close(a1["embeddings"], theirs["r1"].embeddings)
            assert got["stats"]["served"] == len(requests_) - 1 + 2


def test_follower_outlives_an_idle_leader(tmp_path, weights, requests_):
    """Rank 0 idles for three times the followers' group timeout between two
    requests: its idle messages keep rank 1 alive, and both are answered."""
    out = str(tmp_path / "idle.json")
    _run_ranks(tmp_path, "_w_idle", out=out, state=weights[1], path=requests_[0])
    with open(out) as f:
        assert json.load(f) == [["a", True], ["b", True]]
    assert mesh.idle_interval_s() == mesh.TIMEOUT.total_seconds() * mesh.IDLE_SHARE < 1800 / 4


# ---------------------------------------------------------------------------
# the CLIs at --devices 2
# ---------------------------------------------------------------------------


def _serve_lines(text: str) -> dict:
    return {o["id"]: o for o in (json.loads(line) for line in text.splitlines()
                                 if line.startswith('{"id"'))}


def _saved_rows(path: str) -> dict:
    if path.endswith(".npz"):  # ragged columns, keyed by name
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return {"rows": np.load(path)}


def test_serve_cli_on_two_ranks(tmp_path, requests_, checkpoints, capsys):
    """``cli.serve --devices 2`` over JSONL, WavLM and combined, answers
    every request as ``--devices 1`` does: the same lines keyed by id, rows
    within 1e-5; rank 1 writes nothing."""
    wavlm, whisper = checkpoints
    reqs = tmp_path / "reqs.jsonl"
    paths = requests_[:3] + [p for p in requests_ if "undecodable" in p]
    reqs.write_text("".join(json.dumps({"id": f"q{i}", "path": p}) + "\n"
                            for i, p in enumerate(paths)))
    runs, ones = [], []
    for model_type in ("wavlm", "combined"):
        argv = ["--model_type", model_type, "--model_name", wavlm, "--whisper_model_name",
                whisper, "--input", str(reqs), "--device", "cpu", "--preset", "fidelity",
                "--max_wait_ms", "10", "--buckets", "0.5", "--long_clip_policy", "trim"]
        assert serve_cli.main(argv + ["--output_dir", str(tmp_path / f"one_{model_type}"),
                                      "--devices", "1"]) == 0
        ones.append(_serve_lines(capsys.readouterr().out))
        runs.append(("stutter_tpu_torch.cli.serve",
                     argv + ["--output_dir", str(tmp_path / f"two_{model_type}"),
                             "--devices", "2"]))
    for one, (reports, stdout) in zip(ones, _cli_ranks(tmp_path, runs)):
        assert [r["rc"] for r in reports] == [0, 0] and reports[1]["written"] == []
        two = _serve_lines(stdout)
        assert sorted(two) == sorted(one) == [f"q{i}" for i in range(len(paths))]
        for req_id, a in one.items():
            b = two[req_id]
            assert {k: v for k, v in a.items() if k != "file"} == \
                {k: v for k, v in b.items() if k != "file"}
            if a["ok"]:
                ra, rb = _saved_rows(a["file"]), _saved_rows(b["file"])
                for k in ra:
                    for x, y in zip(np.atleast_2d(ra[k]), np.atleast_2d(rb[k])):
                        assert cosine_distance(x, y) <= COSINE, (req_id, k)


def test_predict_cli_on_two_ranks(tmp_path, checkpoints):
    """``cli.predict --devices 2`` (the chunk policy, one clip over the top
    bucket) writes the one-process run's CSV: labels equal, probabilities
    within 1e-5."""
    from stutter_tpu.audio.synthetic import make_synthetic_corpus
    from tests.test_torch_predict import _make_artifact, _read_csv

    corpus = str(tmp_path / "corpus")
    make_synthetic_corpus(corpus, n_per_split={"train": 3, "test": 2}, seed=9,
                          duration_range=(0.3, 0.9))
    wave = load_audio(sorted(glob.glob(os.path.join(corpus, "wav", "*.wav")))[0])
    write_wav(os.path.join(corpus, "wav", "zz_long.wav"), np.tile(wave, 20)[:40_000], 16000)
    model_path = _make_artifact(str(tmp_path / "clf"), "layer_2", 32)
    argv = ["--audio_dir", os.path.join(corpus, "wav"), "--classifier_model", model_path,
            "--model_type", "wavlm", "--model_name", checkpoints[0], "--device", "cpu",
            "--preset", "fidelity", "--batch_size", "4", "--audio_budget", "4",
            "--long_files", "chunk", "--max_length", "1.0"]
    one, two = str(tmp_path / "one.csv"), str(tmp_path / "two.csv")
    assert predict_cli.main(argv + ["--output", one, "--devices", "1"]) == 0
    run_bounded([[sys.executable, "-m", "stutter_tpu_torch.cli.predict", *argv, "--output", two,
                  "--devices", "2", "--keep_embeddings_dir", str(tmp_path / "store")]])
    (h1, r1), (h2, r2) = _read_csv(one), _read_csv(two)
    assert h1 == h2 and len(r1) == len(r2) == 6
    for a, b in zip(r1, r2):
        assert {k: v for k, v in a.items() if not k.startswith("prob_")} == \
            {k: v for k, v in b.items() if not k.startswith("prob_")}
        np.testing.assert_allclose([float(a[k]) for k in h1 if k.startswith("prob_")],
                                   [float(b[k]) for k in h1 if k.startswith("prob_")],
                                   atol=1e-5)


def test_trainer_clis_on_two_ranks(tmp_path, checkpoints):
    """``cli.train`` and ``cli.train_grid`` on a [2, 1] group with
    augmentation: rank 0 writes the one-process run's results CSVs, and rank
    1 writes nothing under the results directory."""
    from tests.test_torch_downstream_train import _write_store

    store = str(tmp_path / "emb_store")
    _write_store(store, {"train": (12, 5, 3), "test": (4, 3, 2), "devel": (3, 2, 2)}, dim=32,
                 layers=("layer_1", "layer_2"))
    base = ["--embeddings_dir", store, "--device", "cpu", "--model_name", checkpoints[0],
            "--preset", "fidelity", "--augmentation_factor", "1", "--minority_threshold", "6"]
    clis = {"train": ["--classifier", "linear", "--head_epochs", "5"],
            "train_grid": ["--use_class_weights", "false", "--model_type", "wavlm"]}
    runs = []
    for name, extra in clis.items():
        module = f"stutter_tpu_torch.cli.{name}"
        argv = base + extra
        with mock.patch.dict("sys.modules", {"matplotlib": None}):
            assert __import__(module, fromlist=["main"]).main(
                argv + ["--results_dir", str(tmp_path / f"one_{name}")]) == 0
        runs.append((module, argv + ["--results_dir", str(tmp_path / f"two_{name}"),
                                     "--devices", "2"]))
    for name, (reports, _) in zip(clis, _cli_ranks(tmp_path, runs)):
        assert [r["rc"] for r in reports] == [0, 0] and reports[1]["written"] == []
        for f in ("all_results_comparison.csv", "layer_comparison_summary.csv"):
            with open(tmp_path / f"one_{name}" / f) as a, \
                    open(tmp_path / f"two_{name}" / f) as b:
                assert a.read() == b.read(), (name, f)


# ---------------------------------------------------------------------------
# the data multiple, against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("data", [1, 2, 4])
@pytest.mark.parametrize("kind", ["wavlm", "whisper"])
def test_make_bucket_batcher_multiple_matches_jax(data, kind):
    from stutter_tpu.cli import common as jax_common

    ex = types.SimpleNamespace(preferred_buckets=(30.0,)) if kind == "whisper" else \
        types.SimpleNamespace(frame_align=(400, 320, 16))
    plan = mesh.MeshPlan(rank=0, world_size=data, data_size=data, model_size=1)
    kw = dict(audio_budget_s=20.0, max_batch=6, max_length_s=12.0 if kind == "wavlm" else None)
    ours = common.make_bucket_batcher(ex, plan=plan if data > 1 else None, **kw)
    theirs = jax_common.make_bucket_batcher(ex, types.SimpleNamespace(data_size=data)
                                            if data > 1 else None, **kw)
    assert ours.batch_multiple == theirs.batch_multiple == data
    assert ours.buckets_s == theirs.buckets_s
    for b in ours.buckets_s:
        assert ours.batch_size_for(b) == theirs.batch_size_for(b)
        assert ours.batch_size_for(b) % data == 0
        assert ours.bucket_samples(b) == theirs.bucket_samples(b)


def test_embed_waves_pads_to_the_data_size_as_jax(tmp_path, weights):
    """``_embed_waves`` at [2, 1]: the chunk of 3 rounds up to 4 and the last
    batch of 3 clips to 4 (a pad row not ok), the batches JAX's padding
    gives cut in two between the ranks; rank 0's rows those of one
    process within 1e-5."""
    from stutter_tpu.train import augment_extract as jae

    rng = np.random.RandomState(3)
    waves = [(0.2 * rng.randn(n)).astype(np.float32)
             for n in (9_000, 12_000, 4_000, 15_000, 7_000, 11_000, 8_000)]
    wave_file = str(tmp_path / "waves.npz")
    np.savez(wave_file, **{f"w{i}": w for i, w in enumerate(waves)})
    out = str(tmp_path / "embed")
    _run_ranks(tmp_path, "_w_embed_waves", out=out, state=weights[1], waves=wave_file)
    ranks = []
    for r in range(2):
        with open(f"{out}.{r}", "rb") as f:
            ranks.append(pickle.load(f))
    assert ranks[1]["rows"] is None

    class JaxSpy:  # the JAX function's batches, with a mesh of data size 2
        mesh = types.SimpleNamespace(data_size=2)
        frame_align = (*WavLMConfig.tiny().stem_geometry, 16)
        column_names = ["c"]

        def __init__(self):
            self.batches = []

        def __call__(self, batch):
            self.batches.append(batch)
            return {"c": np.zeros((len(batch.waves), 1), np.float32)}

    spy = JaxSpy()
    jae._embed_waves(spy, waves, chunk=3)
    assert [len(b.waves) for b in spy.batches] == [4, 4]
    for j, batch in enumerate(spy.batches):
        for k, field in enumerate((batch.waves, batch.lengths, batch.ok)):
            np.testing.assert_array_equal(
                np.concatenate([ranks[0]["seen"][j][k], ranks[1]["seen"][j][k]]), field)
    model = WavLMModel(WavLMConfig.tiny())
    model.load_state_dict(torch.load(weights[1]))
    one = ae._embed_waves(WavLMExtractor(model, "cpu", preset="fidelity"), waves, chunk=3)
    for c, rows in one.items():
        assert ranks[0]["rows"][c].shape == rows.shape == (len(waves), 32)
        for x, y in zip(ranks[0]["rows"][c], rows):
            assert cosine_distance(x, y) <= COSINE, c
