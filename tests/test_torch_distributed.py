"""stutter_tpu_torch.parallel across processes (gloo, CPU), against the JAX package's mesh runs.

Each test starts its ranks as processes of their own that meet through a
``FileStore`` under ``tmp_path`` (init timeout 60 s; every process bounded
and killed on failure), runs a module-level ``_w_*`` function of this file
on each, and holds what rank 0 wrote against the JAX package on the virtual
CPU devices of ``tests/conftest.py`` and against the one-process port:
the plan's groups, data-parallel extraction (store, CSV, checkpoints,
resume), tensor-parallel WavLM and Whisper forwards, turbo's row-parallel
int8 accumulators, the data-parallel fine-tune step (with accumulation) and
the sharded step of ``dryrun_multichip``, plain and with ``int8_forward``.
The ranks import torch and the port only.
"""

import dataclasses
import datetime
import glob
import json
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from stutter_tpu_torch.extract.batcher import Batch, BucketBatcher
from stutter_tpu_torch.extract.checkpoint import find_latest_checkpoint, load_checkpoint
from stutter_tpu_torch.extract.pipeline import (
    ExtractionPipeline,
    WavLMExtractor,
    WhisperExtractor,
)
from stutter_tpu_torch.extract.scanner import create_metadata_from_files
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel
from stutter_tpu_torch.parallel.mesh import gather_rows, make_plan, shard_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240
# tensor- and data-parallel f32 rows against the JAX mesh runs and the
# one-process port: the same products summed in another order
POOLED_COSINE = 1e-5
ROW_ATOL = 1e-5
# bf16 (fast) tensor-parallel rows against the unsharded port: the
# row-parallel partials are summed in f32 and rounded to bf16 once, as the
# CPU's whole bf16 product rounds its f32 sum (measured <= 2.3e-10)
FAST_POOLED_COSINE = 1e-6
# the sharded dryrun step against JAX's: loss (relative) and gradient cosine
# distance per group, f32; and each tensor's max error over its max (the
# gate's small tensors measured <= 7.9e-6, where a missing model-group sum
# leaves 0.6-2)
DRYRUN_LOSS_REL = DRYRUN_GRAD_COSINE = 1e-6
DRYRUN_GRAD_REL = 1e-4
# the same with int8_forward: an activation that the two packages' f32 sums
# put on either side of an int8 rounding boundary moves the loss by 6.1e-6
# (relative), the groups' cosine distance to <= 5.8e-8 and the small gate
# bias's gradient by 2.3e-3 of its max (the one-process port is off JAX's
# step by as much). A rank-local weight scale moves them by 1.3e-2, 1.1e-2
# and 0.85.
DRYRUN_INT8_LOSS_REL = 1e-4
DRYRUN_INT8_GRAD_COSINE = 1e-6
DRYRUN_INT8_GRAD_REL = 2e-2


def run_bounded(cmds, cwd=REPO, timeout=RANK_TIMEOUT_S) -> list[str]:
    """Run the commands at once, each in a session of its own; return their
    outputs. A failure or a timeout kills every process of every session."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, start_new_session=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("ranks timed out:\n" + "\n---\n".join(outs))
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rc={p.returncode}:\n" + "\n---\n".join(outs)
    return outs


def _run_ranks(tmp_path, world: int, fn: str, **kw) -> None:
    """``fn(**kw)`` on ``world`` gloo ranks (processes)."""
    args = (world, str(tmp_path / "store"), fn, json.dumps(kw))
    code = (f"import sys; sys.path[:0] = {[os.path.join(REPO, 'tests'), REPO]!r}; "
            "import test_torch_distributed as t; t._rank_main(%d, *%r)")
    run_bounded([[sys.executable, "-c", code % (r, args)] for r in range(world)])


def _rank_main(rank: int, world: int, store: str, fn: str, kw: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        globals()[fn](**json.loads(kw))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# what the ranks run
# ---------------------------------------------------------------------------


def _model(kind: str, state: str):
    cls, cfg = ((WavLMModel, WavLMConfig.tiny()) if kind == "wavlm"
                else (WhisperModel, WhisperConfig.tiny()))
    model = cls(cfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(torch.load(state))
    return model


def _extractor(kind: str, model, plan, preset: str = "fidelity"):
    cls = WavLMExtractor if kind == "wavlm" else WhisperExtractor
    return cls(model, "cpu", preset=preset, plan=plan)


def _batcher_kw(kind: str) -> dict:
    # sized in frames for the tiny 20x WavLM stem; Whisper pads every clip to 30 s
    if kind == "wavlm":
        return dict(buckets_s=(1.0, 2.0), audio_budget_s=8.0, batch_multiple=2)
    return dict(buckets_s=(30.0,), audio_budget_s=120.0, max_batch=4, batch_multiple=2)


def _w_groups(out: str) -> None:
    rank = dist.get_rank()
    tp, dp = make_plan(data=1, model=2), make_plan(data=2)
    sums = []
    for group in (tp.model_group, dp.data_group, tp.data_group):
        t = torch.tensor([rank + 1.0])
        dist.all_reduce(t, group=group)
        sums.append(float(t))
    try:
        make_plan(data=3, model=2)
        error = ""
    except ValueError as e:
        error = str(e)
    got = {"tp": [tp.data_rank, tp.model_rank, tp.data_size, tp.model_size],
           "dp": [dp.data_rank, dp.model_rank, dp.data_size, dp.model_size],
           "sums": sums, "gather_tp": gather_rows(tp, rank), "gather_dp": gather_rows(dp, rank),
           "rows": [shard_rows(dp, 8).start, shard_rows(dp, 8).stop], "error": error}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(got, f)


def _policy(kind: str) -> str:
    # WavLM's corpus has files over its top bucket: chunked across the ranks
    return "chunk" if kind == "wavlm" else "trim"


def _w_extract(out: str, kind: str, state: str, corpus: str) -> None:
    """A data-parallel run, then a resumed run into the same store that
    records the paths each rank submits."""
    plan = make_plan(data=2)
    ex = _extractor(kind, _model(kind, state), plan)
    pipe = ExtractionPipeline(ex, batcher=BucketBatcher(**_batcher_kw(kind)),
                              checkpoint_interval=3, long_file_policy=_policy(kind))
    meta = create_metadata_from_files(corpus)
    store = os.path.join(out, "dp")
    pipe.run(meta, store)
    done = {}
    for split in ("train", "test", "devel"):
        n = find_latest_checkpoint(store, split)
        done[split] = [r["path"] for r in load_checkpoint(store, split, n)] if n else []
    seen, submit = [], ex.submit
    ex.submit = lambda batch: (seen.extend(batch.paths), submit(batch))[1]
    pipe.run(meta, store, resume=True)
    with open(os.path.join(out, f"resume{plan.rank}.json"), "w") as f:
        json.dump({"checkpointed": done, "submitted": seen}, f)


def _load_batch(path: str) -> Batch:
    z = np.load(path)
    n = len(z["waves"])
    return Batch(paths=[f"c{i}" for i in range(n)], rows=list(range(n)), waves=z["waves"],
                 lengths=z["lengths"], ok=np.ones(n, bool), bucket_s=float(z["bucket_s"]))


def _w_tp(out: str, kind: str, state: str, batch: str, preset: str) -> None:
    plan = make_plan(data=1, model=2)
    pooled = _extractor(kind, _model(kind, state), plan, preset)(_load_batch(batch))
    if plan.rank == 0:
        np.savez(os.path.join(out, "tp.npz"), **pooled)


def _w_qdot(out: str, data: str) -> None:
    from stutter_tpu_torch.ops.quant import qdot_accumulators
    from stutter_tpu_torch.parallel.sharding import cut

    plan = make_plan(data=1, model=2)
    z = np.load(data)
    x = cut(torch.from_numpy(z["x"]), 1, plan.model_rank, 2)
    q = cut(torch.from_numpy(z["q"]), 1, plan.model_rank, 2)
    acc, scale = qdot_accumulators(x, q, plan.model_group)
    if plan.rank == 0:
        np.savez(os.path.join(out, "acc.npz"), acc=acc.numpy(), scale=scale.numpy())


def _finetune_cfg():
    from stutter_tpu_torch.train.finetune import FinetuneConfig

    model = dataclasses.replace(WavLMConfig.tiny(32, 2, 4), apply_spec_augment=False)
    return FinetuneConfig(model=model, activation_dtype=torch.float32, n_classes=3,
                          head_hidden=(16,), head_dropout=0.0)


def _w_finetune(out: str, params: str, batches: str, grad_accum: int) -> None:
    from stutter_tpu_torch.train.finetune import FinetuneTrainer
    from stutter_tpu_torch.weights.convert import finetune_params_to_numpy, flatten_tree

    plan = make_plan(data=2)
    cfg = _finetune_cfg()
    trainer = FinetuneTrainer(cfg, device="cpu", params=torch.load(params), plan=plan,
                              grad_accum=grad_accum)
    z = np.load(batches)
    mine = shard_rows(plan, z["waves"].shape[1])
    mbs = [tuple(z[k][i][mine] for k in ("waves", "lengths", "labels", "valid"))
           for i in range(len(z["waves"]))]
    if grad_accum == 1:
        (w, l, y, v), = mbs
        aux = trainer.step(w, l, y, z["class_weights"], valid=v)
    else:
        aux = trainer.step_accum(mbs, z["class_weights"])
    if plan.rank == 0:
        np.savez(os.path.join(out, "params.npz"),
                 **flatten_tree(finetune_params_to_numpy(trainer.state_dict(), cfg.model)))
        with open(os.path.join(out, "aux.json"), "w") as f:
            json.dump(aux, f)


def _w_dryrun(out: str, params: str, int8_forward: bool = False) -> None:
    from stutter_tpu_torch.parallel import dryrun

    if int8_forward:  # the step's trainer takes its config from dryrun_config
        base = dryrun.dryrun_config
        dryrun.dryrun_config = lambda *a: dataclasses.replace(base(*a), int8_forward=True)
    plan = make_plan(data=1, model=2)
    loss, _, grads, _ = dryrun.dryrun_step(plan, "cpu", torch.load(params), random_draws=False)
    np.savez(os.path.join(out, f"grads{plan.rank}.npz"),
             **{k: g.numpy() for k, g in grads.items() if g is not None})
    with open(os.path.join(out, f"loss{plan.rank}.json"), "w") as f:
        json.dump(loss, f)


# ---------------------------------------------------------------------------
# the tests (this process: JAX and the one-process port)
# ---------------------------------------------------------------------------


def _cosine(a, b) -> float:
    from tests.conftest import cosine_distance

    return cosine_distance(a, b)


def test_plan_groups_on_two_ranks(tmp_path):
    _run_ranks(tmp_path, 2, "_w_groups", out=str(tmp_path))
    r0, r1 = (json.load(open(tmp_path / f"rank{r}.json")) for r in range(2))
    assert r0["tp"] == [0, 0, 1, 2] and r1["tp"] == [0, 1, 1, 2]
    assert r0["dp"] == [0, 0, 2, 1] and r1["dp"] == [1, 0, 2, 1]
    # the model group and the data group span both ranks; a data group of
    # the [1, 2] layout is the rank alone
    assert r0["sums"] == [3.0, 3.0, 1.0] and r1["sums"] == [3.0, 3.0, 2.0]
    # rank 0 gathers one part per data rank
    assert r0["gather_tp"] == [0] and r0["gather_dp"] == [0, 1]
    assert r1["gather_tp"] is None and r1["gather_dp"] is None
    assert r0["rows"] == [0, 4] and r1["rows"] == [4, 8]
    assert "mesh 3x2 != 2 ranks" in r0["error"] == r1["error"]


def _jax_params(kind: str):
    """(JAX params as numpy, JAX config, the port's state dict) of one seeded init."""
    import jax

    from stutter_tpu.models import WavLMConfig as JaxWavLM
    from stutter_tpu.models import WhisperConfig as JaxWhisper
    from stutter_tpu.models import init_wavlm_params, init_whisper_params
    from stutter_tpu_torch.weights.convert import (
        wavlm_params_from_numpy,
        whisper_params_from_numpy,
    )

    if kind == "wavlm":
        jcfg = JaxWavLM.tiny()
        tree = jax.tree.map(np.asarray, init_wavlm_params(jax.random.key(0), jcfg))
        return tree, jcfg, wavlm_params_from_numpy(tree, WavLMConfig.tiny())
    jcfg = JaxWhisper.tiny()
    tree = jax.tree.map(np.asarray, init_whisper_params(jax.random.key(0), jcfg))
    return tree, jcfg, whisper_params_from_numpy(tree, WhisperConfig.tiny())


def _jax_extractor(kind, tree, jcfg, mesh):
    from stutter_tpu.extract import WavLMExtractor as JaxWavLM
    from stutter_tpu.extract import WhisperExtractor as JaxWhisper

    return (JaxWavLM if kind == "wavlm" else JaxWhisper)(jcfg, tree, mesh=mesh,
                                                         preset="fidelity")


def _store(root: str, split: str, columns) -> tuple[bytes, dict]:
    d = os.path.join(root, split)
    with open(os.path.join(d, "embedding_metadata.csv"), "rb") as f:
        csv = f.read()
    return csv, {c: np.load(os.path.join(d, f"{c}_embeddings.npy")) for c in columns}


@pytest.mark.parametrize("kind", ["wavlm", "whisper"])
def test_dp_extraction_matches_one_process_and_jax(tmp_path, kind):
    """Two data ranks write the store, the CSV and the checkpoints of the
    one-process run, rows within 1e-5 cosine of JAX's WavLMExtractor /
    WhisperExtractor on a data=2 mesh (WavLM with two files over the top
    bucket, chunked: each chunk batch split over the ranks); a resumed run
    re-extracts no checkpointed row."""
    import jax

    from stutter_tpu.audio.synthetic import make_synthetic_corpus
    from stutter_tpu.extract import BucketBatcher as JaxBatcher
    from stutter_tpu.extract import ExtractionPipeline as JaxPipeline
    from stutter_tpu.extract import create_metadata_from_files as jax_scan
    from stutter_tpu.parallel.mesh import make_mesh

    corpus = str(tmp_path / "corpus")
    n = {"train": 8, "test": 4, "devel": 2} if kind == "wavlm" else {"train": 5, "test": 2}
    make_synthetic_corpus(corpus, n_per_split=n, duration_range=(0.3, 1.8), seed=3)
    if kind == "wavlm":
        from stutter_tpu_torch.audio.wavio import write_wav

        for i, seconds in enumerate((4.3, 5.1)):
            wave = np.random.RandomState(i).randn(int(seconds * 16000)).astype(np.float32)
            write_wav(os.path.join(corpus, "wav", f"train_long{i}.wav"), 0.1 * wave, 16000)
        n["train"] += 2
    tree, jcfg, state = _jax_params(kind)
    torch.save(state, tmp_path / "state.pt")
    _run_ranks(tmp_path, 2, "_w_extract", out=str(tmp_path), kind=kind,
               state=str(tmp_path / "state.pt"), corpus=corpus)

    ex = _extractor(kind, _model(kind, str(tmp_path / "state.pt")), None)
    meta = create_metadata_from_files(corpus)
    one = str(tmp_path / "one")
    ExtractionPipeline(ex, batcher=BucketBatcher(**_batcher_kw(kind)), checkpoint_interval=3,
                       long_file_policy=_policy(kind)).run(meta, one)
    jex = _jax_extractor(kind, tree, jcfg, make_mesh(jax.devices()[:2], data=2))
    JaxPipeline(jex, batcher=JaxBatcher(**_batcher_kw(kind)), checkpoint_interval=3,
                long_file_policy=_policy(kind)).run(jax_scan(corpus), str(tmp_path / "jax"))

    dp = str(tmp_path / "dp")
    for split in n:
        csv, rows = _store(dp, split, ex.column_names)
        csv_one, rows_one = _store(one, split, ex.column_names)
        _, rows_jax = _store(str(tmp_path / "jax"), split, ex.column_names)
        assert csv == csv_one
        for c in ex.column_names:
            assert rows[c].shape == (n[split], ex.embedding_dim)
            np.testing.assert_allclose(rows[c], rows_one[c], rtol=0, atol=ROW_ATOL)
            assert max(_cosine(a, b) for a, b in zip(rows[c], rows_jax[c])) <= POOLED_COSINE
    ckpts = sorted(glob.glob(os.path.join(one, "checkpoints", "*.pkl")))
    assert ckpts
    for path in ckpts:
        mine = os.path.join(dp, "checkpoints", os.path.basename(path))
        with open(path, "rb") as f, open(mine, "rb") as g:
            ref, got = pickle.load(f), pickle.load(g)
        assert [r["path"] for r in got] == [r["path"] for r in ref]
        for a, b in zip(got, ref):
            for c in ex.column_names:
                np.testing.assert_allclose(a[c], b[c], rtol=0, atol=ROW_ATOL)

    resumed = [json.load(open(tmp_path / f"resume{r}.json")) for r in range(2)]
    checkpointed = {p for paths in resumed[0]["checkpointed"].values() for p in paths}
    submitted = {p for r in resumed for p in r["submitted"]}  # a file's chunks on both ranks
    assert checkpointed and not checkpointed & submitted
    assert len(submitted) == len(meta) - len(checkpointed)


def _tp_batch(kind: str, path) -> Batch:
    rs = np.random.RandomState(7)
    if kind == "wavlm":  # frames of the tiny 20x stem: L = 399
        n, lengths = 8000, np.array([8000, 5000, 2600])
    else:
        n, lengths = 32000, np.array([32000, 16000])
    waves = (rs.randn(len(lengths), n) * 0.1).astype(np.float32)
    for i, m in enumerate(lengths):
        waves[i, m:] = 0.0
    np.savez(path, waves=waves, lengths=lengths, bucket_s=n / 16000)
    return _load_batch(path)


@pytest.mark.parametrize("kind,preset", [("wavlm", "fidelity"), ("whisper", "fidelity"),
                                         ("wavlm", "turbo"), ("wavlm", "fast"),
                                         ("whisper", "fast")])
def test_tp_forward_matches_jax_and_one_process(tmp_path, kind, preset):
    """Two model ranks (WavLM tiny: 4 heads, 2 a rank; Whisper tiny the
    same), f32 plain path: the pooled rows within 1e-5 cosine of JAX's
    extractor on a [1, 2] mesh and of the unsharded port. Turbo: every WavLM
    projection is int8, whose accumulators the row-parallel products sum
    exactly, so the rows are the unsharded turbo rows bit for bit. Fast
    (bf16, the row-parallel products in ``tf32``): within 1e-6 of the
    unsharded port."""
    import jax

    from stutter_tpu.extract.batcher import Batch as JaxBatch
    from stutter_tpu.parallel.mesh import make_mesh

    tree, jcfg, state = _jax_params(kind)
    torch.save(state, tmp_path / "state.pt")
    batch = _tp_batch(kind, tmp_path / "batch.npz")
    _run_ranks(tmp_path, 2, "_w_tp", out=str(tmp_path), kind=kind,
               state=str(tmp_path / "state.pt"), batch=str(tmp_path / "batch.npz"),
               preset=preset)
    tp = np.load(tmp_path / "tp.npz")
    one = _extractor(kind, _model(kind, str(tmp_path / "state.pt")), None, preset)(batch)
    if preset == "turbo":
        for c, rows in one.items():
            np.testing.assert_array_equal(tp[c], rows, err_msg=c)
        return
    if preset == "fast":
        for c, rows in one.items():
            assert max(_cosine(a, b) for a, b in zip(tp[c], rows)) <= FAST_POOLED_COSINE, c
        return
    jex = _jax_extractor(kind, tree, jcfg, make_mesh(jax.devices()[:2], data=1, model=2))
    ref = jex(JaxBatch(**{f.name: getattr(batch, f.name)
                          for f in dataclasses.fields(batch)}))
    for c, rows in one.items():
        assert max(_cosine(a, b) for a, b in zip(tp[c], rows)) <= POOLED_COSINE, c
        assert max(_cosine(a, b) for a, b in zip(tp[c], ref[c])) <= POOLED_COSINE, c


def test_turbo_row_parallel_accumulators_bit_equal_jax(tmp_path):
    """A row-parallel int8 product on two model ranks: the per-token absmax
    is all-reduced (MAX) before quantising, and the int32 partial sums are
    all-reduced; the accumulators and scales equal JAX's under a [1, 2]
    mesh (x and the weight cut on the contraction axis) bit for bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from stutter_tpu.ops.quant import quantize_weight
    from stutter_tpu.parallel.mesh import make_mesh

    rs = np.random.RandomState(11)
    x = rs.randn(5, 64).astype(np.float32)
    x[:, 40:] *= 8.0  # the per-token max lies in the second rank's slice
    w = jax.tree.map(np.asarray, quantize_weight(jnp.asarray(rs.randn(64, 48), jnp.float32)))
    np.savez(tmp_path / "data.npz", x=x, q=w["q"].T.copy())
    _run_ranks(tmp_path, 2, "_w_qdot", out=str(tmp_path), data=str(tmp_path / "data.npz"))
    ours = np.load(tmp_path / "acc.npz")

    mesh = make_mesh(jax.devices()[:2], data=1, model=2).mesh

    def qdot_parts(x, wq):
        s = jnp.maximum(jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0, 1e-8)
        xq = jnp.clip(jnp.round(x / s), -127, 127).astype(jnp.int8)
        return jax.lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32), s

    xs = jax.device_put(x, NamedSharding(mesh, P(None, "model")))
    ws = jax.device_put(w["q"], NamedSharding(mesh, P("model", None)))
    acc, scale = (np.asarray(a) for a in jax.jit(qdot_parts)(xs, ws))
    assert ours["acc"].dtype == np.int32
    np.testing.assert_array_equal(ours["acc"], acc)
    np.testing.assert_array_equal(ours["scale"], scale)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_dp_finetune_step_matches_jax(tmp_path, rng, grad_accum):
    """Two data ranks, unequal class weights and a valid = 0 row on the
    second rank only: the loss and the parameters after AdamW within
    tests/test_torch_finetune.py's f32 bars of JAX's FinetuneTrainer on a
    data=2 mesh (the global weighted mean, not a mean of rank means)."""
    import jax
    import jax.numpy as jnp

    from stutter_tpu.parallel.mesh import make_mesh
    from stutter_tpu.train import finetune as jft
    from stutter_tpu_torch.weights.convert import finetune_params_from_numpy, flatten_tree
    from tests.test_torch_finetune import F32_STEP_REL, _assert_params_close, _batch, _jax_cfg

    cfg = _finetune_cfg()
    jcfg = jft.FinetuneConfig(model=_jax_cfg(cfg.model), activation_dtype=jnp.float32,
                              n_classes=3, head_hidden=(16,), head_dropout=0.0)
    jt = jft.FinetuneTrainer(jcfg, mesh=make_mesh(jax.devices()[:2], data=2),
                             grad_accum=grad_accum)
    torch.save(finetune_params_from_numpy(jax.tree.map(np.asarray, jt.params), cfg.model),
               tmp_path / "params.pt")
    mbs = [_batch(rng) for _ in range(grad_accum)]
    cw = np.array([1.0, 2.0, 0.5], np.float32)
    np.savez(tmp_path / "batches.npz", class_weights=cw,
             **{k: np.stack([mb[i] for mb in mbs])
                for i, k in enumerate(("waves", "lengths", "labels", "valid"))})
    _run_ranks(tmp_path, 2, "_w_finetune", out=str(tmp_path), params=str(tmp_path / "params.pt"),
               batches=str(tmp_path / "batches.npz"), grad_accum=grad_accum)
    if grad_accum == 1:
        (w, l, y, v), = mbs
        aux = jt.step(w, l, y, cw, valid=v)
    else:
        aux = jt.step_accum(mbs, cw)
    ours = json.load(open(tmp_path / "aux.json"))
    np.testing.assert_allclose(ours["loss"], aux["loss"], rtol=F32_STEP_REL)
    assert ours["accuracy"] == pytest.approx(aux["accuracy"])
    params = dict(np.load(tmp_path / "params.npz"))
    ref = flatten_tree(jax.tree.map(np.asarray, jt.params))
    assert set(params) == set(ref)
    _assert_params_close(params, ref, cfg.backbone_lr)


def test_dryrun_tp_step_matches_jax(tmp_path):
    """dryrun_multichip's step at [data 1, model 2], dropout and SpecAugment
    off: the loss and each rank's gradients (cut as the ranks hold them)
    against the JAX dryrun's step on its [1, 2] mesh, from the same numpy
    weights and batch."""
    _dryrun_tp_vs_jax(tmp_path, int8_forward=False)


def test_dryrun_tp_int8_forward_step_matches_jax(tmp_path):
    """The same step with int8_forward: the six projections of each layer
    through qdot_ste. The row-parallel o_w and w2 hold half of the
    contraction axis on each rank, so each rank must quantize its half with
    the whole weight's per-channel scale (JAX's GSPMD takes the absmax over
    the whole axis); a rank-local scale moves the sums of the int32
    accumulators off the product and the gradients off JAX's."""
    _dryrun_tp_vs_jax(tmp_path, int8_forward=True)


def _dryrun_tp_vs_jax(tmp_path, int8_forward: bool) -> None:
    import jax
    import jax.numpy as jnp

    from stutter_tpu.models import WavLMConfig as JaxWavLM
    from stutter_tpu.parallel.mesh import make_mesh
    from stutter_tpu.parallel.sharding import shard_params, wavlm_param_spec
    from stutter_tpu.train import finetune as jft
    from stutter_tpu.train.heads import weighted_softmax_xent
    from stutter_tpu_torch.parallel.dryrun import dryrun_batch, dryrun_config
    from stutter_tpu_torch.parallel.sharding import WAVLM_LAYER_DIMS, cut, shard_dim
    from stutter_tpu_torch.weights.convert import finetune_params_from_numpy

    cfg = dryrun_config(random_draws=False)
    jcfg = jft.FinetuneConfig(
        model=JaxWavLM(**dataclasses.asdict(cfg.model)), n_classes=4, head_hidden=(32,),
        head_dropout=0.0, activation_dtype=jnp.float32, remat_encoder=True,
        int8_forward=int8_forward)
    tree = jax.tree.map(np.asarray, jft.init_finetune_params(jcfg))
    torch.save(finetune_params_from_numpy(tree, cfg.model), tmp_path / "params.pt")
    _run_ranks(tmp_path, 2, "_w_dryrun", out=str(tmp_path), params=str(tmp_path / "params.pt"),
               int8_forward=int8_forward)

    # the JAX dryrun's batch (__graft_entry__.dryrun_multichip) is the port's
    rs = np.random.RandomState(0)
    waves = rs.randn(2, 3200).astype(np.float32) * 0.1
    labels = rs.randint(0, 4, size=2).astype(np.int32)
    ours = dryrun_batch(1)
    np.testing.assert_array_equal(ours[0], waves)
    np.testing.assert_array_equal(ours[2], labels)
    plan = make_mesh(jax.devices()[:2], data=1, model=2)
    params = dict(tree, backbone=shard_params(plan, tree["backbone"], wavlm_param_spec(plan)))

    def loss_fn(p):
        logits = jft.finetune_forward(p, waves, np.full((2,), 3200, np.int32), jcfg,
                                      train=True, rng=jax.random.key(1))
        return weighted_softmax_xent(logits, labels, jnp.ones((4,)), valid=jnp.ones((2,)))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    full = finetune_params_from_numpy(jax.tree.map(np.asarray, grads), cfg.model)
    loss_rel, grad_cosine, grad_rel = (
        (DRYRUN_INT8_LOSS_REL, DRYRUN_INT8_GRAD_COSINE, DRYRUN_INT8_GRAD_REL) if int8_forward
        else (DRYRUN_LOSS_REL, DRYRUN_GRAD_COSINE, DRYRUN_GRAD_REL))
    for r in range(2):
        assert abs(json.load(open(tmp_path / f"loss{r}.json")) / float(loss) - 1) <= loss_rel
        got = dict(np.load(tmp_path / f"grads{r}.npz"))
        ref = {k: cut(v, shard_dim(k, WAVLM_LAYER_DIMS), r, 2) for k, v in full.items()}
        for group in ("backbone.", "layer_weights", "head."):
            names = sorted(k for k in got if k.startswith(group))
            assert names
            a = np.concatenate([got[k].ravel() for k in names])
            b = np.concatenate([ref[k].numpy().ravel() for k in names])
            assert _cosine(a, b) <= grad_cosine, (r, group, _cosine(a, b))
        for k in got:
            if k.endswith("k_b"):  # its exact gradient is 0 (a row's scores shift alike)
                continue
            b = ref[k].numpy()
            assert np.abs(got[k] - b).max() <= grad_rel * np.abs(b).max(), (r, k)
