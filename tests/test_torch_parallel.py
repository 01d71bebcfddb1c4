"""stutter_tpu_torch.parallel in one process, against the JAX package's mesh layer.

The [data, model] plan's shapes, its padding and row slices, the model axis
fastest (``tests/test_mesh.py``'s contract), every WavLM and Whisper
tensor's tensor-parallel cut against the JAX ``NamedSharding``'s shard of
the same numpy array (turbo's int8 ``{q, s}`` included), the batcher's
``batch_multiple`` and row shards, the mesh flags' checks, and the entry
points that default to the card. What needs several processes is in
``tests/test_torch_distributed.py``.
"""

import dataclasses
import inspect
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from stutter_tpu.extract.batcher import BucketBatcher as JaxBatcher
from stutter_tpu.extract.pipeline import cast_params_for_preset
from stutter_tpu.models import WavLMConfig as JaxWavLMConfig
from stutter_tpu.models import WhisperConfig as JaxWhisperConfig
from stutter_tpu.models import init_wavlm_params, init_whisper_params
from stutter_tpu.parallel.mesh import make_mesh
from stutter_tpu.parallel.sharding import _lookup, wavlm_param_spec, whisper_param_spec
from stutter_tpu_torch.audio import wavio
from stutter_tpu_torch.extract.batcher import BucketBatcher
from stutter_tpu_torch.extract.pipeline import cast_for_preset
from stutter_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from stutter_tpu_torch.models.whisper import WhisperConfig, WhisperModel
from stutter_tpu_torch.parallel.mesh import MeshPlan, plan_shape, rank_grid, shard_rows
from stutter_tpu_torch.parallel.sharding import shard_wavlm, shard_whisper
from stutter_tpu_torch.weights.convert import wavlm_params_from_numpy, whisper_params_from_numpy

torch.set_num_threads(2)  # six xdist workers share the host


def _plan(rank: int, data: int, model: int) -> MeshPlan:
    """A rank's plan with no groups: enough to cut weights and rows."""
    return MeshPlan(rank=rank, world_size=data * model, data_size=data, model_size=model)


def test_plan_shapes_match_jax():
    devices = jax.devices()
    for data, model in ((None, 1), (4, 2), (None, 2), (2, 4), (1, 8)):
        ours = plan_shape(8, data, model)
        ref = make_mesh(devices, data=data, model=model)
        assert ours == (ref.data_size, ref.model_size)
    for data, model in ((3, 2), (None, 3), (1, 4)):
        with pytest.raises(ValueError, match="mesh"):
            make_mesh(devices, data=data, model=model)
        with pytest.raises(ValueError, match="mesh"):
            plan_shape(8, data, model)


def test_model_axis_fastest_as_in_jax():
    """Rank r sits where JAX puts the r-th device of the list it is given:
    the model axis fastest, so that a tensor-parallel group is consecutive
    ranks, which a launcher numbering hosts in turn keeps on one host."""
    devices = jax.devices()
    order = list(devices[4:]) + list(devices[:4])  # a host-major order of two hosts
    position = {id(d): i for i, d in enumerate(order)}
    for data, model in ((4, 2), (2, 4), (8, 1), (1, 8)):
        grid = make_mesh(order, data=data, model=model).mesh.devices
        ref = np.vectorize(lambda d: position[id(d)])(grid)
        np.testing.assert_array_equal(rank_grid(data, model), ref)
        for r in range(8):
            p = _plan(r, data, model)
            assert rank_grid(data, model)[p.data_rank, p.model_rank] == r
    grid = rank_grid(4, 2)
    assert all(grid[i, 0] // 4 == grid[i, 1] // 4 for i in range(4))  # pairs on one host


def test_shard_rows_cover_the_batch_in_order():
    for data in (1, 2, 4):
        rows = np.concatenate([np.arange(12)[shard_rows(_plan(d * 2, data, 2), 12)]
                               for d in range(data)])
        np.testing.assert_array_equal(rows, np.arange(12))
    assert shard_rows(None, 5) == slice(0, 5)
    with pytest.raises(ValueError, match="does not split"):
        shard_rows(_plan(0, 4, 1), 6)


def _jax_shard(tree, spec_tree, mesh, model_rank: int):
    """Every leaf of ``tree`` cut as JAX's NamedSharding places it on the
    device of model index ``model_rank`` (numpy, f32)."""
    device = mesh.mesh.devices[0, model_rank]

    def cut(path, leaf):
        spec = _lookup(spec_tree, path)
        index = NamedSharding(mesh.mesh, spec).devices_indices_map(leaf.shape)[device]
        return np.asarray(leaf, np.float32)[index]

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return None if node is None else cut(path, np.asarray(node))

    return walk(tree)


def _split_quantized(tree):
    """(the tree with each int8 {q, s, cs} replaced by its q, {path: (q, s)})."""
    quantized = {}

    def walk(node, path):
        if isinstance(node, dict) and set(node) == {"q", "s", "cs"}:
            quantized[path] = (node["q"], node["s"])
            return node["q"]
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        return node

    return walk(tree, ""), quantized


def _assert_cut_like_jax(model, params, spec, mesh, to_port, plan, layer_name):
    """The port's cut state dict equals the JAX shard, tensor by tensor."""
    ours = {k: v.float() for k, v in model.state_dict().items()}
    shard = _jax_shard(params, spec, mesh, plan.model_rank)
    plain, quantized = _split_quantized(shard)
    ref = to_port(plain)
    checked = set()
    for path, (q, s) in quantized.items():
        for i in range(q.shape[0]):
            name = layer_name(path, i)
            np.testing.assert_array_equal(ours[f"{name}.q"].numpy(), q[i].T, err_msg=name)
            np.testing.assert_array_equal(ours[f"{name}.s"].numpy(), s[i], err_msg=name)
            checked |= {f"{name}.q", f"{name}.s", name}
    assert set(ref) - checked == set(ours) - checked
    for k in set(ref) - checked:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k].numpy(), err_msg=k)


WAVLM_PORT_NAMES = {"q_w": "attention.q_w", "k_w": "attention.k_w", "v_w": "attention.v_w",
                    "o_w": "attention.o_w", "ff_w1": "feed_forward.w1",
                    "ff_w2": "feed_forward.w2"}


@pytest.mark.parametrize("preset", ["fidelity", "turbo"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_wavlm_cuts_like_the_jax_spec(preset, tp):
    jcfg = JaxWavLMConfig.tiny(hidden_size=32, layers=2, heads=4)
    cfg = WavLMConfig(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, init_wavlm_params(jax.random.key(0), jcfg))
    mesh = make_mesh(jax.devices()[:tp], data=1, model=tp)
    jparams = jax.tree.map(np.asarray, cast_params_for_preset(params, preset))
    for r in range(tp):
        plan = _plan(r, 1, tp)
        model = WavLMModel(cfg, device="meta").to_empty(device="cpu")
        model.load_state_dict(wavlm_params_from_numpy(params, cfg))
        model = shard_wavlm(cast_for_preset(model, torch.device("cpu"), preset), plan)
        assert model.layers[0].attention.heads == 4 // tp
        assert model.head_range == (r * 4 // tp, (r + 1) * 4 // tp)
        _assert_cut_like_jax(
            model, jparams, wavlm_param_spec(mesh), mesh,
            lambda t: wavlm_params_from_numpy(t, cfg), plan,
            lambda path, i: f"layers.{i}.{WAVLM_PORT_NAMES[path.rsplit('/', 1)[1]]}")


@pytest.mark.parametrize("preset", ["fidelity", "turbo"])
def test_shard_whisper_cuts_like_the_jax_spec(preset):
    jcfg = JaxWhisperConfig.tiny(d_model=32, layers=2, heads=4)
    cfg = WhisperConfig(**dataclasses.asdict(jcfg))
    params = jax.tree.map(np.asarray, init_whisper_params(jax.random.key(0), jcfg))
    mesh = make_mesh(jax.devices()[:2], data=1, model=2)
    jparams = jax.tree.map(np.asarray, cast_params_for_preset(params, preset))

    def layer_name(path, i):  # encoder/layers/attn_q_w -> encoder.layers.i.attn.q_w
        block, _, key = path.split("/")
        prefix, _, rest = key.partition("_")
        name = f"{prefix}.{rest}" if prefix in ("attn", "xattn") else f"ffn.{key}"
        return f"{block}.layers.{i}.{name}"

    for r in range(2):
        plan = _plan(r, 1, 2)
        model = WhisperModel(cfg, device="meta").to_empty(device="cpu")
        model.load_state_dict(whisper_params_from_numpy(params, cfg))
        model = shard_whisper(cast_for_preset(model, torch.device("cpu"), preset), plan)
        assert model.encoder.layers[0].attn.heads == model.decoder.layers[0].xattn.heads == 2
        _assert_cut_like_jax(model, jparams, whisper_param_spec(mesh), mesh,
                             lambda t: whisper_params_from_numpy(t, cfg), plan, layer_name)


def test_heads_must_divide_by_the_model_size():
    with pytest.raises(ValueError, match="4 heads"):
        shard_wavlm(WavLMModel(WavLMConfig.tiny(32, 2, 4), device="meta"), _plan(0, 1, 3))
    with pytest.raises(ValueError, match="4 heads"):
        shard_whisper(WhisperModel(WhisperConfig.tiny(32, 2, 4), device="meta"),
                      _plan(0, 1, 3))
    # one model rank, or no plan, leaves the model whole
    model = WavLMModel(WavLMConfig.tiny(32, 2, 4), device="meta")
    assert shard_wavlm(model, _plan(1, 2, 1)) is model and model.tp_group is None


@pytest.mark.parametrize("kw", [
    dict(batch_multiple=2),
    dict(batch_multiple=4, max_batch=6, audio_budget_s=30.0),
    dict(batch_multiple=8, frame_align=(400, 320, 16)),
    dict(batch_multiple=3, audio_budget_s=8.0),
])
def test_batcher_multiple_matches_jax(kw):
    ours, ref = BucketBatcher(**kw), JaxBatcher(**kw)
    for b in ours.buckets_s:
        assert ours.batch_size_for(b) == ref.batch_size_for(b)
        assert ours.batch_size_for(b) % kw["batch_multiple"] == 0


def test_batcher_shards_are_the_batch(tmp_path):
    """Each data rank decodes its contiguous rows of each batch; together
    they are the whole batch (pad rows included), in order."""
    paths = []
    for i, n in enumerate([3000, 9000, 16000, 4000, 12000, 7000, 15000]):
        paths.append(str(tmp_path / f"c{i}.wav"))
        wavio.write_wav(paths[-1], np.random.RandomState(i).randn(n).astype(np.float32) * 0.1,
                        16000)
    batcher = BucketBatcher(buckets_s=(0.5, 1.0), audio_budget_s=2.0, batch_multiple=2)
    whole = list(batcher.batches(paths, prefetch=False))
    shards = [list(batcher.batches(paths, shard=(d, 2))) for d in range(2)]
    assert len(whole) == len(shards[0]) == len(shards[1])
    for full, parts in zip(whole, zip(*shards)):
        assert [r for p in parts for r in p.rows] == full.rows
        assert [q for p in parts for q in p.paths] == full.paths
        np.testing.assert_array_equal(np.concatenate([p.waves for p in parts]), full.waves)
        np.testing.assert_array_equal(np.concatenate([p.ok for p in parts]), full.ok)
    with pytest.raises(ValueError, match="batch_multiple"):
        next(BucketBatcher(batch_multiple=1).batches(paths, shard=(0, 2)))


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The trainer, its model init and the served classifier run on the card
    unless the caller names the CPU; with no card they raise."""
    from stutter_tpu_torch.serve.classify import ServingClassifier
    from stutter_tpu_torch.train.finetune import (
        FinetuneConfig,
        FinetuneTrainer,
        init_finetune_model,
    )

    for fn in (FinetuneTrainer.__init__, init_finetune_model, ServingClassifier.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FinetuneConfig(model=WavLMConfig.tiny(32, 2, 4), n_classes=2)
    for call in (lambda: FinetuneTrainer(cfg), lambda: init_finetune_model(cfg),
                 lambda: ServingClassifier.load(str(tmp_path / "m_model.npz"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_dryrun_never_moves_to_the_cpu(monkeypatch):
    from stutter_tpu_torch.parallel.dryrun import dryrun_multichip

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        dryrun_multichip(2)


@pytest.mark.parametrize("entry", ["extract_wavlm", "extract_whisper", "finetune"])
def test_mesh_flags_are_checked_before_any_worker(tmp_path, entry):
    """--tp must divide --devices (and --devices 1 takes no --tp above 1):
    the layout fails in the calling process, before a rank is spawned."""
    import importlib

    cli = importlib.import_module(f"stutter_tpu_torch.cli.{entry}")
    out = "--results_dir" if entry == "finetune" else "--output_dir"
    base = ["--data_dir", str(tmp_path), out, str(tmp_path / "o"), "--random_init",
            "--device", "cpu"]
    for extra in (["--devices", "2", "--tp", "3"], ["--tp", "2"], ["--devices", "3", "--tp", "2"]):
        with pytest.raises(ValueError, match="mesh"):
            cli.main(base + extra)
    args = cli.parse_args(base + ["--devices"])
    assert args.devices is None and args.tp == 1  # the flag alone: every visible card


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_on_cpu_ranks(n):
    """dryrun_multichip(n, device="cpu"): [n / tp, tp] gloo ranks (tp = 2
    for an even n) take one sharded step and rank 0 prints the OK line."""
    from tests.test_torch_distributed import run_bounded

    code = ("from stutter_tpu_torch.parallel.dryrun import dryrun_multichip; "
            f"dryrun_multichip({n}, device='cpu')")
    out, = run_bounded([[sys.executable, "-c", code]])
    model = 2 if n % 2 == 0 else 1
    line, = [l for l in out.splitlines() if l.startswith("dryrun_multichip OK")]
    assert f"mesh data={n // model} model={model}, batch={2 * n // model}" in line
    assert np.isfinite(float(line.rsplit("loss=", 1)[1]))


def _cli_store(tmp_path, entry: str, ckpt: str, corpus: str, devices: list, out: str):
    from tests.test_torch_distributed import run_bounded

    argv = [sys.executable, "-m", f"stutter_tpu_torch.cli.{entry}", "--data_dir", corpus,
            "--output_dir", out, "--model_path", ckpt, "--device", "cpu", "--preset",
            "fidelity", "--split", "train", "--batch_size", "4", *devices]
    if entry == "extract_wavlm":
        argv += ["--audio_budget", "4", "--max_length", "1.0"]
    run_bounded([argv])


@pytest.mark.parametrize("entry,devices", [("extract_wavlm", ["--devices", "2"]),
                                           ("extract_whisper", ["--devices", "2", "--tp", "2"])])
def test_extraction_cli_on_two_cpu_ranks(tmp_path, entry, devices):
    """``--devices 2`` (WavLM: two data ranks; Whisper with ``--tp 2``: two
    model ranks) on ``--device cpu``: the CLI spawns its ranks and writes the
    store of the one-process run (rows within 1e-5 cosine, the same CSV)."""
    from stutter_tpu.audio.synthetic import make_synthetic_corpus
    from tests.conftest import cosine_distance
    from tests.test_torch_checkpoint import HF_WAVLM, _hf_wavlm, _hf_whisper, _save

    hf = _hf_wavlm(HF_WAVLM) if entry == "extract_wavlm" else _hf_whisper()
    ckpt = _save(hf, str(tmp_path / "ckpt"), "safetensors")
    corpus = str(tmp_path / "corpus")
    make_synthetic_corpus(corpus, n_per_split={"train": 5}, duration_range=(0.3, 0.9), seed=4)
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    _cli_store(tmp_path, entry, ckpt, corpus, ["--devices", "1"], one)
    _cli_store(tmp_path, entry, ckpt, corpus, devices, two)
    with open(os.path.join(one, "train", "embedding_metadata.csv"), "rb") as f:
        csv = f.read()
    with open(os.path.join(two, "train", "embedding_metadata.csv"), "rb") as f:
        assert f.read() == csv
    names = [p for p in os.listdir(os.path.join(one, "train")) if p.endswith(".npy")]
    assert names
    for name in names:
        a, b = (np.load(os.path.join(d, "train", name)) for d in (one, two))
        assert a.shape == b.shape == (5, 32)
        assert max(cosine_distance(x, y) for x, y in zip(a, b)) <= 1e-5, name
    assert not [p for p in os.listdir(two) if p.startswith(".torch_dist_store")]


def test_finetune_cli_on_two_cpu_ranks(tmp_path):
    """``cli.finetune --devices 2`` on ``--device cpu``: two data ranks train,
    checkpoint, resume with accumulation, and rank 0 writes the results."""
    from stutter_tpu.audio.synthetic import make_synthetic_corpus
    from stutter_tpu_torch.train.checkpointing import latest_step
    from tests.test_torch_checkpoint import HF_WAVLM, _hf_wavlm, _save
    from tests.test_torch_distributed import run_bounded

    ckpt = _save(_hf_wavlm(HF_WAVLM), str(tmp_path / "ckpt"), "safetensors")
    corpus = str(tmp_path / "corpus")
    make_synthetic_corpus(corpus, n_per_split={"train": 8, "test": 3}, duration_range=(0.3, 0.6),
                          seed=6)
    results, state = str(tmp_path / "results"), str(tmp_path / "state")
    argv = [sys.executable, "-m", "stutter_tpu_torch.cli.finetune", "--data_dir", corpus,
            "--results_dir", results, "--model_path", ckpt, "--batch_size", "4",
            "--max_length", "1.0", "--device", "cpu", "--devices", "2",
            "--checkpoint_dir", state]
    run_bounded([argv + ["--epochs", "1"]])
    assert latest_step(state) == 1
    run_bounded([argv + ["--epochs", "2", "--resume", "--grad_accum", "2"]])
    assert latest_step(state) == 2
    assert os.path.isfile(os.path.join(results, "finetune_results.json"))
    saved = np.load(os.path.join(results, "wavlm_finetune_weighted_sum_mlp_model.npz"))
    assert saved["backbone/encoder/layers/q_w"].shape == (2, 32, 32)
