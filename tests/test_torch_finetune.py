"""stutter_tpu_torch's fine-tuning against the JAX package's.

The same numpy inputs and the same weights (carried across by
``finetune_params_from_numpy``) through ``stutter_tpu.train.finetune`` and
``stutter_tpu_torch.train.finetune``: one f32 step (loss, logits, the
parameters after AdamW), one bf16 step at WavLM-Large widths against JAX's
f32 gradients, gradient accumulation, the frozen backbone, SpecAugment, the
head, the loss, the optimizer, class weights and metrics, checkpoints and
resume, the parameter converters, and the CLI on the CPU.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stutter_tpu.models import WavLMConfig as JaxConfig
from stutter_tpu.ops import specaugment as jsa
from stutter_tpu.train import finetune as jft
from stutter_tpu.train import heads as jheads
from stutter_tpu.train.class_weights import compute_class_weights as jax_class_weights
from stutter_tpu.train.metrics import classification_metrics as jax_metrics
from stutter_tpu_torch.cli import finetune as cli
from stutter_tpu_torch.models.wavlm import WavLMConfig
from stutter_tpu_torch.ops import specaugment as tsa
from stutter_tpu_torch.train import heads as theads
from stutter_tpu_torch.train.checkpointing import (
    latest_step, restore_train_state, save_train_state)
from stutter_tpu_torch.train.class_weights import compute_class_weights
from stutter_tpu_torch.train.data import build_label_maps
from stutter_tpu_torch.train.finetune import (
    FinetuneConfig, FinetuneTrainer, finetune_forward, param_label)
from stutter_tpu_torch.train.metrics import classification_metrics
from stutter_tpu_torch.train.optim import MultiAdamW
from stutter_tpu_torch.weights.convert import (
    finetune_params_from_numpy, finetune_params_to_numpy, flatten_tree)
from tests.conftest import cosine_distance

torch.set_num_threads(2)  # six xdist workers share the host

# f32 step against JAX's f32 step: relative to each leaf's max. The sums run
# in another order (CPU BLAS in both), so ~1e-7 is what separates them.
F32_STEP_REL = 1e-5
# bf16 port step against JAX's f32 gradients at WavLM-Large widths, 2 layers:
# cosine distance per group (measured 3.5e-5 encoder, 9.3e-5 layer weights,
# 2.8e-5 head). The port keeps its attention logits in f32 where JAX's bf16
# path rounds them to bf16; what separates the two here is the bf16
# rounding of every activation, which the bar allows ten times over.
BF16_GRAD_COSINE = 1e-3


def _jax_cfg(cfg: WavLMConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def _tiny():
    return dataclasses.replace(WavLMConfig.tiny(32, 2, 4), apply_spec_augment=False)


def _configs(mcfg, dtype="f32", **kw):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                     torch.bfloat16)
    common = dict(n_classes=3, head_hidden=(16,), head_dropout=0.0, **kw)
    return (jft.FinetuneConfig(model=_jax_cfg(mcfg), activation_dtype=jdt, **common),
            FinetuneConfig(model=mcfg, activation_dtype=tdt, **common))


def _batch(rng, b=4, n=3200):
    waves = (rng.randn(b, n) * 0.1).astype(np.float32)
    lengths = np.full((b,), n, np.int32)
    lengths[1] = n * 5 // 8
    waves[1, lengths[1]:] = 0.0
    labels = rng.randint(0, 3, size=b).astype(np.int32)
    valid = np.ones((b,), np.float32)
    valid[-1] = 0.0  # a pad row
    return waves, lengths, labels, valid


def _tree(trainer, mcfg):
    return flatten_tree(finetune_params_to_numpy(trainer.state_dict(), mcfg))


def _pair(mcfg, dtype="f32", grad_accum=1, **kw):
    jcfg, tcfg = _configs(mcfg, dtype, **kw)
    jt = jft.FinetuneTrainer(jcfg, grad_accum=grad_accum)
    tree = jax.tree.map(np.asarray, jt.params)
    tt = FinetuneTrainer(tcfg, device="cpu", params=finetune_params_from_numpy(tree, mcfg),
                         grad_accum=grad_accum)
    return jt, tt, tree


def _assert_params_close(ours, ref, lr):
    for k, b in ref.items():
        a = ours[k]
        if k.endswith("layers/k_b"):
            # the key bias shifts every score of a row alike, so its exact
            # gradient is 0: both packages take AdamW steps of +-lr on noise
            np.testing.assert_allclose(a, b, atol=2.1 * lr, err_msg=k)
            continue
        denom = max(1e-12, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_STEP_REL * denom, err_msg=k)


def test_f32_step_matches_jax(rng):
    mcfg = _tiny()
    jt, tt, tree = _pair(mcfg)
    waves, lengths, labels, valid = _batch(rng)
    cw = np.array([1.0, 2.0, 0.5], np.float32)
    logits_j = np.asarray(jft.finetune_forward(jt.params, jnp.asarray(waves),
                                               jnp.asarray(lengths), jt.cfg))
    with torch.no_grad():
        logits_t = finetune_forward(tt.model, torch.from_numpy(waves),
                                    torch.from_numpy(lengths).long(), tt.cfg).numpy()
    np.testing.assert_allclose(logits_t, logits_j, rtol=F32_STEP_REL, atol=F32_STEP_REL)
    aux_j = jt.step(waves, lengths, labels, cw, valid=valid)
    aux_t = tt.step(waves, lengths, labels, cw, valid=valid)
    np.testing.assert_allclose(aux_t["loss"], aux_j["loss"], rtol=F32_STEP_REL)
    assert aux_t["accuracy"] == pytest.approx(aux_j["accuracy"])
    ref = flatten_tree(jax.tree.map(np.asarray, jt.params))
    ours = _tree(tt, mcfg)
    assert set(ours) == set(ref)
    _assert_params_close(ours, ref, tt.cfg.backbone_lr)
    moved = flatten_tree(tree)
    assert not np.array_equal(ours["backbone/encoder/layers/q_w"],
                              moved["backbone/encoder/layers/q_w"])
    # the frozen stem did not move
    np.testing.assert_array_equal(ours["backbone/feature_encoder/conv_layers/0/w"],
                                  moved["backbone/feature_encoder/conv_layers/0/w"])


def test_grad_accum_matches_big_batch(rng):
    """K=2 microbatches equal one 2B batch (tests/test_grad_accum.py's contract)."""
    _, cfg = _configs(_tiny())
    cw = np.array([1.0, 2.0, 0.5], np.float32)
    mb1, mb2 = _batch(rng), _batch(rng)
    big = tuple(np.concatenate([a, b]) for a, b in zip(mb1, mb2))
    accum = FinetuneTrainer(cfg, device="cpu", grad_accum=2)
    ref = FinetuneTrainer(cfg, device="cpu")
    aux_a = accum.step_accum([mb1, mb2], cw)
    aux_r = ref.step(*big[:3], cw, valid=big[3])
    np.testing.assert_allclose(aux_a["loss"], aux_r["loss"], atol=1e-5)
    np.testing.assert_allclose(aux_a["accuracy"], aux_r["accuracy"], atol=1e-6)
    a, r = accum.state_dict(), ref.state_dict()
    for k in r:
        tol = 2.1 * cfg.backbone_lr if k.endswith("attention.k_b") else 5e-5
        torch.testing.assert_close(a[k], r[k], rtol=0, atol=tol, msg=k)

    # a short group, padded with valid=0
    padded = FinetuneTrainer(cfg, device="cpu", grad_accum=3)
    exact = FinetuneTrainer(cfg, device="cpu", grad_accum=2)
    aux_p = padded.step_accum([mb1, mb2], cw)
    aux_e = exact.step_accum([mb1, mb2], cw)
    np.testing.assert_allclose(aux_p["loss"], aux_e["loss"], atol=1e-6)
    p, e = padded.state_dict(), exact.state_dict()
    for k in e:
        torch.testing.assert_close(p[k], e[k], rtol=0, atol=1e-7, msg=k)
    with pytest.raises(ValueError):
        exact.step_accum([mb1, mb2, mb1], cw)


def test_freeze_backbone_trains_only_the_head(rng):
    _, cfg = _configs(_tiny(), freeze_backbone=True)
    trainer = FinetuneTrainer(cfg, device="cpu")
    before = {k: v.clone() for k, v in trainer.state_dict().items()}
    waves, lengths, labels, valid = _batch(rng)
    trainer.step(waves, lengths, labels, np.ones(3, np.float32), valid=valid)
    after = trainer.state_dict()
    for k in before:
        if k.startswith("backbone."):
            assert torch.equal(before[k], after[k]), k
    assert not torch.equal(before["head.layers.0.w"], after["head.layers.0.w"])
    assert not torch.equal(before["layer_weights"], after["layer_weights"])
    assert all(param_label(n, cfg) == "frozen" for n in before if n.startswith("backbone."))


@pytest.fixture(scope="module")
def large_two_layers():
    """WavLM-Large widths, 2 layers: JAX's f32 gradients and the port's bf16
    gradients of one step on the same weights and batch."""
    mcfg = dataclasses.replace(WavLMConfig.large(), num_hidden_layers=2,
                               apply_spec_augment=False)
    jcfg, _ = _configs(mcfg, "f32")
    _, tcfg = _configs(mcfg, "bf16")
    params = jft.init_finetune_params(jcfg)
    tree = jax.tree.map(np.asarray, params)
    r = np.random.RandomState(2)
    waves = (r.randn(2, 16000) * 0.1).astype(np.float32)
    lengths = np.array([16000, 9600], np.int32)
    waves[1, 9600:] = 0.0
    labels, valid = np.array([0, 2], np.int32), np.ones(2, np.float32)
    cw = np.array([1.0, 2.0, 0.5], np.float32)

    def loss(p):
        logits = jft.finetune_forward(p, jnp.asarray(waves), jnp.asarray(lengths), jcfg,
                                      train=True)
        return jheads.weighted_softmax_xent(logits, jnp.asarray(labels), jnp.asarray(cw),
                                            valid=jnp.asarray(valid))

    loss_j, grads_j = jax.value_and_grad(loss)(params)
    trainer = FinetuneTrainer(tcfg, device="cpu", params=finetune_params_from_numpy(tree, mcfg))
    batch = trainer._tensors(waves, lengths, labels, valid)
    grads_t, loss_t, _ = trainer.gradients([batch], cw, normalize_in_graph=True)
    state = {n: torch.zeros_like(p) for n, p in trainer.state_dict().items()}
    state.update({n: g for n, g in grads_t.items() if g is not None})
    ours = flatten_tree(finetune_params_to_numpy(state, mcfg))
    ref = flatten_tree(jax.tree.map(np.asarray, grads_j))
    return float(loss_j), float(loss_t), ours, ref


def test_bf16_step_at_large_widths_matches_jax_f32(large_two_layers):
    loss_j, loss_t, ours, ref = large_two_layers
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-2)
    groups = {"encoder": [k for k in ref if k.startswith("backbone/")
                          and not k.startswith("backbone/feature_encoder/")],
              "layer_weights": ["layer_weights"],
              "head": [k for k in ref if k.startswith("head/")]}
    for name, keys in groups.items():
        a = np.concatenate([ours[k].ravel() for k in keys])
        b = np.concatenate([ref[k].ravel() for k in keys])
        d = cosine_distance(a, b)
        print(f"{name}: port bf16 vs JAX f32 gradient cosine distance {d:.3e}")
        assert np.isfinite(a).all() and d <= BF16_GRAD_COSINE, (name, d)
    stem = [k for k in ours if k.startswith("backbone/feature_encoder/")]
    assert stem and all(not ours[k].any() for k in stem)  # the stem gets no gradient


def test_spec_augment_matches_jax_given_the_same_masks(rng):
    B, L, D = 3, 40, 16
    hidden = rng.randn(B, L, D).astype(np.float32)
    lengths = np.array([40, 25, 33], np.int32)
    emb = rng.rand(D).astype(np.float32)
    key = jax.random.key(3)
    prob, span, fprob, fspan = 0.2, 5, 0.3, 4
    ref = np.asarray(jsa.spec_augment(key, jnp.asarray(hidden), jnp.asarray(lengths), prob,
                                      span, fprob, fspan, jnp.asarray(emb)))
    t_rng, f_rng = jax.random.split(key)
    starts_t = np.asarray(jax.random.bernoulli(t_rng, prob / span, (B, L)))
    starts_f = np.asarray(jax.random.bernoulli(f_rng, fprob / fspan, (B, D)))
    tmask = tsa.expand_spans(torch.from_numpy(starts_t), span)
    fmask = tsa.expand_spans(torch.from_numpy(starts_f), fspan)
    np.testing.assert_array_equal(
        tmask.numpy(), np.asarray(jsa._span_mask(t_rng, (B, L), prob, span)))
    ours = tsa.spec_augment(torch.from_numpy(hidden), torch.from_numpy(lengths).long(),
                            prob, span, fprob, fspan, torch.from_numpy(emb),
                            time_mask=tmask, feature_mask=fmask).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours != hidden).any()


def test_span_mask_rate():
    g = torch.Generator().manual_seed(0)
    prob, span, L = 0.05, 10, 4000
    mask = tsa.span_mask(g, (256, L), prob, span)
    # interior positions are masked with probability 1 - (1 - prob/span)^span
    expected = 1.0 - (1.0 - prob / span) ** span
    # ~5000 spans: the standard error of the rate is ~7e-4
    assert abs(float(mask[:, span:].float().mean()) - expected) < 3e-3


def test_head_and_loss_match_jax(rng):
    x = rng.randn(5, 12).astype(np.float32)
    params = jheads.init_head_params(jax.random.key(1), jheads.HeadConfig(12, 4, (8,)))
    head = theads.MLPHead(theads.HeadConfig(12, 4, (8,)))
    with torch.no_grad():
        for layer, p in zip(head.layers, params):
            layer.w.copy_(torch.from_numpy(np.asarray(p["w"])))
            layer.b.copy_(torch.from_numpy(np.asarray(p["b"]) + 0.1))
            p["b"] = p["b"] + 0.1
    with torch.no_grad():
        ours = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jheads.head_forward(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    # the tanh GELU, not the erf form
    z = np.linspace(-4, 4, 33).astype(np.float32)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(torch.from_numpy(z), approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(z))), atol=1e-6)

    logits = rng.randn(6, 4).astype(np.float32)
    labels = np.array([0, 3, 1, 1, 2, 0], np.int32)
    cw = np.array([1.0, 0.5, 2.0, 1.5], np.float32)
    valid = np.array([1, 1, 0, 1, 1, 0], np.float32)
    for smoothing in (0.0, 0.1):
        a = theads.weighted_xent_sums(torch.from_numpy(logits), torch.from_numpy(labels),
                                      torch.from_numpy(cw), smoothing,
                                      torch.from_numpy(valid))
        b = jheads.weighted_xent_sums(jnp.asarray(logits), jnp.asarray(labels),
                                      jnp.asarray(cw), smoothing, jnp.asarray(valid))
        np.testing.assert_allclose([float(t) for t in a], [float(t) for t in b], rtol=1e-6)
    zero_valid = torch.zeros(6)
    loss = theads.weighted_softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                                        torch.from_numpy(cw), valid=zero_valid)
    assert float(loss) == 0.0  # the 1e-9 floor, not a division by zero


def test_class_weights_metrics_and_label_maps_match_jax(rng):
    from stutter_tpu.train.data import build_label_maps as jax_label_maps

    y = rng.randint(0, 4, size=50)
    y[y == 2] = 1  # one absent class
    np.testing.assert_allclose(compute_class_weights(y, 5), jax_class_weights(y, 5))
    y_pred = rng.randint(0, 5, size=50)
    ours, ref = classification_metrics(y, y_pred, 5), jax_metrics(y, y_pred, 5)
    np.testing.assert_array_equal(ours.pop("confusion_matrix"), ref.pop("confusion_matrix"))
    assert ours == ref
    labels = ["block", "no_disfluency", None, "block", "", "prolongation"]
    ours_maps = build_label_maps(labels)
    ref_maps = jax_label_maps([x if x else None for x in labels])
    assert ours_maps == ref_maps


def test_optimizer_matches_optax_adamw_bf16_mu(rng):
    """MultiAdamW against optax.multi_transform of adamw(mu_dtype=bf16) and
    set_to_zero, three steps of random gradients."""
    shapes = {"backbone": {"feature_encoder": {"w": (3, 4)}, "encoder": {"w": (5, 6),
                                                                         "b": (6,)}},
              "layer_weights": (3,), "head": [{"w": (6, 2), "b": (2,)}]}
    tree = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32), shapes,
                        is_leaf=lambda s: isinstance(s, tuple))
    jcfg, tcfg = _configs(_tiny())
    tx = jft.make_optimizer(jcfg, tree)
    params_j = jax.tree.map(jnp.asarray, tree)
    state_j = tx.init(params_j)
    names = {"backbone/feature_encoder/w": "backbone.feature_encoder.w",
             "backbone/encoder/w": "backbone.encoder.w", "backbone/encoder/b": "backbone.encoder.b",
             "layer_weights": "layer_weights", "head/0/w": "head.layers.0.w",
             "head/0/b": "head.layers.0.b"}
    flat = flatten_tree(tree)
    params_t = {names[k]: torch.from_numpy(v.copy()) for k, v in flat.items()}
    opt = MultiAdamW(params_t, {n: param_label(n, tcfg) for n in params_t},
                     {"backbone": tcfg.backbone_lr, "head": tcfg.head_lr},
                     tcfg.weight_decay, mu_dtype=torch.bfloat16)
    assert opt.labels["backbone.feature_encoder.w"] == "frozen"
    for _ in range(3):
        grads = jax.tree.map(lambda s: rng.randn(*s).astype(np.float32) * 1e-2, shapes,
                             is_leaf=lambda s: isinstance(s, tuple))
        updates, state_j = tx.update(jax.tree.map(jnp.asarray, grads), state_j, params_j)
        params_j = optax.apply_updates(params_j, updates)
        opt.step(params_t, {names[k]: torch.from_numpy(v) for k, v in
                            flatten_tree(grads).items()})
        ref = flatten_tree(jax.tree.map(np.asarray, params_j))
        for k, n in names.items():
            np.testing.assert_allclose(params_t[n].numpy(), ref[k], rtol=1e-6, atol=1e-9,
                                       err_msg=k)
    assert "backbone.feature_encoder.w" not in opt.state["mu"]
    assert all(m.dtype == torch.bfloat16 for m in opt.state["mu"].values())


def test_checkpoint_round_trip_and_resume_equals_uninterrupted(rng, tmp_path):
    _, cfg = _configs(_tiny())
    cw = np.ones(3, np.float32)
    b1, b2 = _batch(rng), _batch(rng)
    straight = FinetuneTrainer(cfg, device="cpu")
    for b in (b1, b2):
        straight.step(*b[:3], cw, valid=b[3])

    first = FinetuneTrainer(cfg, device="cpu")
    first.step(*b1[:3], cw, valid=b1[3])
    ckpt = str(tmp_path / "ckpt")
    save_train_state(ckpt, 1, first.state_dict(), first.opt.state_dict())
    assert latest_step(ckpt) == 1 and os.path.isdir(os.path.join(ckpt, "step_00000001"))
    resumed = FinetuneTrainer(cfg, device="cpu")
    params, opt_state, step = restore_train_state(ckpt, 1, resumed.state_dict(),
                                                  resumed.opt.state_dict())
    assert step == 1
    for k, v in first.state_dict().items():
        assert torch.equal(params[k], v), k
    resumed.model.load_state_dict(params)
    resumed.opt.load_state_dict(opt_state)
    resumed.step(*b2[:3], cw, valid=b2[3])
    for k, v in straight.state_dict().items():
        assert torch.equal(resumed.state_dict()[k], v), k


def test_finetune_params_round_trip_exact():
    mcfg = _tiny()
    jcfg, _ = _configs(mcfg)
    tree = jax.tree.map(np.asarray, jft.init_finetune_params(jcfg))
    state = finetune_params_from_numpy(tree, mcfg)
    ref, back = flatten_tree(tree), flatten_tree(finetune_params_to_numpy(state, mcfg))
    assert set(ref) == set(back)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    again = finetune_params_from_numpy(finetune_params_to_numpy(state, mcfg), mcfg)
    assert set(again) == set(state) and all(torch.equal(again[k], state[k]) for k in state)
    with pytest.raises(ValueError, match="stray"):
        finetune_params_from_numpy(dict(tree, stray=np.zeros(2)), mcfg)
    with pytest.raises(ValueError, match="stray"):
        finetune_params_to_numpy(dict(state, stray=torch.zeros(2)), mcfg)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from stutter_tpu.audio.synthetic import make_synthetic_corpus

    root = str(tmp_path_factory.mktemp("ft_corpus"))
    make_synthetic_corpus(root, n_per_split={"train": 8, "test": 3, "devel": 3},
                          seed=5, duration_range=(0.3, 0.9))
    return root


def test_cli_on_cpu_with_checkpoint_resume_and_grad_accum(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(WavLMConfig, "base", staticmethod(lambda: WavLMConfig.tiny(32, 2, 4)))
    results, ckpt = str(tmp_path / "results"), str(tmp_path / "ckpt")
    common = ["--data_dir", corpus, "--results_dir", results, "--random_init",
              "--model_name", "microsoft/wavlm-base", "--batch_size", "4",
              "--max_length", "1.0", "--device", "cpu", "--checkpoint_dir", ckpt]
    assert cli.main(common + ["--epochs", "1"]) == 0
    assert latest_step(ckpt) == 1
    assert cli.main(common + ["--epochs", "2", "--resume", "--grad_accum", "2"]) == 0
    assert latest_step(ckpt) == 2
    assert os.path.isfile(os.path.join(results, "finetune_results.json"))
    saved = np.load(os.path.join(results, "wavlm_finetune_weighted_sum_mlp_model.npz"))
    assert "backbone/encoder/layers/q_w" in saved and "head/1/w" in saved
    assert os.path.isfile(os.path.join(results, "wavlm_finetune_weighted_sum_mlp_info.json"))


@pytest.mark.parametrize("extra", [[], ["cast_params=False"]])
def test_cli_refuses_what_is_not_ported(tmp_path, extra):
    """Without --random_init a hub name raises OSError naming a local
    checkpoint directory (no download); the one option still not ported,
    cast_params=False with bf16 activations (no CLI flag), raises
    NotImplementedError when the trainer is built. (--devices 2 runs:
    tests/test_torch_parallel.py.)"""
    if not extra:
        argv = ["--data_dir", str(tmp_path), "--results_dir", str(tmp_path / "r")]
        with pytest.raises(OSError, match="local checkpoint directory"):
            cli.main(argv + ["--device", "cpu"])
        return
    _, cfg = _configs(_tiny(), "bf16", cast_params=False)
    with pytest.raises(NotImplementedError, match="cast_params=False"):
        FinetuneTrainer(cfg, device="cpu")


@pytest.mark.parametrize("extra", [["--int8_forward"], ["--remat_policy", "layer_dots"],
                                   ["--remat_policy", "dots"]])
def test_cli_runs_what_it_once_refused(corpus, tmp_path, monkeypatch, extra):
    """int8_forward and the remat policies the port once refused: the CLI
    takes one update on the CPU with each and writes its results."""
    monkeypatch.setattr(WavLMConfig, "base", staticmethod(lambda: WavLMConfig.tiny(32, 2, 4)))
    results = str(tmp_path / "results")
    argv = ["--data_dir", corpus, "--results_dir", results, "--random_init",
            "--model_name", "microsoft/wavlm-base", "--batch_size", "8", "--max_length", "1.0",
            "--device", "cpu", "--epochs", "1", *extra]
    assert cli.main(argv) == 0
    assert os.path.isfile(os.path.join(results, "finetune_results.json"))


def test_cli_raises_without_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--data_dir", str(tmp_path), "--results_dir", str(tmp_path / "r"),
                  "--random_init"])
