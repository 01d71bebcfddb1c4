"""The trainers: the per-layer sweep over the embedding store
(counterpart of ``stutter_tpu/train/trainer.py``; reference C21).

``run_balanced_training`` (``model_training_01.py:689-969``): load the
.npy+CSV store -> split it (positional train / test+devel, or stratified)
-> augment the minority classes and re-extract them (given an extractor) ->
per layer x classifier: SMOTE, fit, metrics -> plots, reports, saved models,
the best result per layer -> the comparison CSVs and the final summary.

``run_grid_training`` (``model_training_1.py:827-1121``): the {Original,
SMOTE} x {SVM, RF} x {Basic, Weighted} grid per layer (plus the heads,
given ``GRID_MODELS_JAX``), with the data-quality and class-distribution
stages.

The output tree is the JAX package's, but for the saved models' format
(``train/persistence.py``). SMOTE, the heads and the re-extraction run on
``TrainConfig.device``.

Given an extractor with a plan (``parallel.mesh.MeshPlan``), every rank
loads the same store and takes part in the re-extraction; then every rank
but rank 0 returns an empty dict. Rank 0 alone fits and writes, as the JAX
package's fits do not use its mesh either.
"""

from __future__ import annotations

import dataclasses
import logging
import os

from stutter_tpu_torch.extract.store import load_embeddings, load_embeddings_combined
from stutter_tpu_torch.report import plots
from stutter_tpu_torch.report.summaries import (
    write_classification_report,
    write_comparison_csv,
    write_final_summary,
    write_layer_summary,
)
from stutter_tpu_torch.train.augment_extract import apply_data_augmentation
from stutter_tpu_torch.train.classifiers import (
    GRID_MODELS,
    train_balanced_model,
    train_improved_models,
)
from stutter_tpu_torch.train.data import (
    build_label_maps,
    positional_split,
    prepare_data,
    stratified_test_mask,
)
from stutter_tpu_torch.train.persistence import save_model, save_results
from stutter_tpu_torch.train.quality import analyze_class_distribution, check_data_quality

logger = logging.getLogger("stutter_tpu_torch.train.trainer")


@dataclasses.dataclass
class TrainConfig:
    embeddings_dir: str
    results_dir: str
    model_type: str = "wavlm"
    classifiers: tuple[str, ...] = ("svm",)  # svm|rf|xgb|mlp|linear
    use_smote: bool = True
    smote_k_neighbors: int = 3
    augmentation_factor: int = 0  # 0 disables re-extraction augmentation
    minority_threshold: int = 100
    random_state: int = 42
    make_plots: bool = True  # needs matplotlib
    head_overrides: dict | None = None  # HeadConfig fields for the heads
    split: str = "predefined"  # "predefined" | "train_test"
    test_size: float = 0.2
    device: str = "cuda"  # SMOTE and the heads


def _split_store(cfg: TrainConfig, metadata: list[dict], embeddings: dict, layer_names):
    """(train_meta, eval_meta, train_emb{}, eval_emb{}) per the split mode."""
    if cfg.split == "train_test":
        # one positional mask slices the metadata and every layer alike
        mask = stratified_test_mask(metadata, cfg.test_size, cfg.random_state)
        train_meta = [r for r, t in zip(metadata, mask) if not t]
        eval_meta = [r for r, t in zip(metadata, mask) if t]
        return (train_meta, eval_meta, {k: v[~mask] for k, v in embeddings.items()},
                {k: v[mask] for k, v in embeddings.items()})
    train_meta, _, eval_meta, _ = positional_split(metadata, embeddings[layer_names[0]])
    n = len(train_meta)
    return (train_meta, eval_meta, {k: v[:n] for k, v in embeddings.items()},
            {k: v[n:] for k, v in embeddings.items()})


def _layer_sort_key(name: str):
    parts = name.rsplit("_", 1)
    return (parts[0], int(parts[1]) if parts[-1].isdigit() else 0)


def _load_store(cfg: TrainConfig):
    if cfg.model_type == "combined":
        return load_embeddings_combined(cfg.embeddings_dir)
    return load_embeddings(cfg.embeddings_dir, cfg.model_type)


def _leads(extractor) -> bool:
    """Whether this process fits and writes: rank 0 of the extractor's plan,
    or the only process."""
    plan = getattr(extractor, "plan", None)
    return plan is None or plan.rank == 0


def _prepare_run(cfg: TrainConfig, extractor):
    """What both trainers share: the store loaded and split, the label map
    over every split, and the augmentation. Returns (layer_names,
    train_meta, eval_meta, train_embeddings, eval_embeddings, labels)."""
    if cfg.make_plots:
        plots.pyplot()  # an ImportError naming matplotlib, before any work
    metadata, embeddings = _load_store(cfg)
    if metadata is None or not embeddings:
        raise FileNotFoundError(
            f"no embeddings found for {cfg.model_type} under {cfg.embeddings_dir}")
    if _leads(extractor):
        os.makedirs(cfg.results_dir, exist_ok=True)

    layer_names = sorted(embeddings, key=_layer_sort_key)
    train_meta, eval_meta, train_embeddings, eval_embeddings = _split_store(
        cfg, metadata, embeddings, layer_names)
    # the label map over ALL splits (the reference fits its encoder on the
    # combined labels, model_training_01.py:470-477), so that a class seen
    # only in eval does not crash
    has_labels = any("label" in row for row in metadata)
    global_labels = build_label_maps(r.get("label") for r in metadata)[0] if has_labels else {}

    if cfg.augmentation_factor > 0:
        if extractor is None:
            logger.warning("augmentation_factor=%d but no extractor provided; skipping "
                           "augmentation re-extraction", cfg.augmentation_factor)
        else:
            train_meta, train_embeddings = apply_data_augmentation(
                train_meta, train_embeddings, extractor,
                augmentation_factor=cfg.augmentation_factor,
                minority_threshold=cfg.minority_threshold, seed=cfg.random_state)
    return layer_names, train_meta, eval_meta, train_embeddings, eval_embeddings, global_labels


def _layer_data(layer, train_meta, eval_meta, train_embeddings, eval_embeddings, global_labels):
    X_train, y_train, label_to_idx, idx_to_label = prepare_data(
        train_meta, train_embeddings[layer], label_to_idx=global_labels or None)
    X_eval, y_eval, _, _ = prepare_data(eval_meta, eval_embeddings[layer], label_to_idx)
    class_names = [str(idx_to_label[i]) for i in range(len(idx_to_label))]
    return X_train, y_train, X_eval, y_eval, idx_to_label, class_names


def _finish(cfg: TrainConfig, all_rows: list[dict], best_per_layer: dict) -> None:
    """The comparison CSVs, the layer plot and the final summary."""
    write_comparison_csv(all_rows, cfg.results_dir)
    write_layer_summary(best_per_layer, cfg.results_dir)
    if cfg.make_plots:
        plots.plot_layer_comparison(best_per_layer, cfg.results_dir)
    best_layer = max(best_per_layer, key=lambda k: best_per_layer[k]["balanced_accuracy"])
    write_final_summary(best_layer, best_per_layer[best_layer], best_per_layer,
                        cfg.results_dir, cfg.model_type)


def _result_row(layer: str, key: str, name: str, r: dict) -> dict:
    return {"layer": layer, key: name, "accuracy": r["accuracy"],
            "balanced_accuracy": r["balanced_accuracy"], "weighted_f1": r["weighted_f1"],
            "macro_f1": r["macro_f1"]}


def run_balanced_training(cfg: TrainConfig, extractor=None) -> dict:
    """The model_training_01 pipeline. Returns {layer: best-result dict} (on
    a rank other than 0 of the extractor's plan, {} after the re-extraction)."""
    layer_names, train_meta, eval_meta, train_emb, eval_emb, global_labels = _prepare_run(
        cfg, extractor)
    if not _leads(extractor):
        return {}
    all_rows: list[dict] = []
    best_per_layer: dict[str, dict] = {}
    for layer in layer_names:
        logger.info("=== layer %s ===", layer)
        X_train, y_train, X_eval, y_eval, _, class_names = _layer_data(
            layer, train_meta, eval_meta, train_emb, eval_emb, global_labels)
        layer_best = None
        for clf_name in cfg.classifiers:
            model, results = train_balanced_model(
                X_train, y_train, X_eval, y_eval, classifier_type=clf_name,
                class_names=class_names, use_smote=cfg.use_smote,
                smote_k_neighbors=cfg.smote_k_neighbors, random_state=cfg.random_state,
                head_overrides=cfg.head_overrides, device=cfg.device)
            tag = f"{layer}_{clf_name}"
            out_dir = os.path.join(cfg.results_dir, layer)
            if cfg.make_plots:
                plots.plot_confusion_matrices(results["confusion_matrix"], class_names, out_dir,
                                              tag)
                plots.plot_per_class_metrics(results["per_class"], out_dir, tag)
            write_classification_report(results, out_dir, tag)
            save_model(model, out_dir, cfg.model_type, layer, clf_name, results,
                       class_names=class_names)
            all_rows.append(_result_row(layer, "classifier", clf_name, results))
            if layer_best is None or results["balanced_accuracy"] > layer_best["balanced_accuracy"]:
                layer_best = results
        best_per_layer[layer] = layer_best

    _finish(cfg, all_rows, best_per_layer)
    save_results({k: {m: v for m, v in r.items() if m not in ("confusion_matrix", "estimator")}
                  for k, r in best_per_layer.items()},
                 cfg.results_dir, "best_per_layer.json")
    return best_per_layer


def run_grid_training(cfg: TrainConfig, extractor=None, model_names=GRID_MODELS) -> dict:
    """The model_training_1 pipeline (grid trainer + quality stages); {} on a
    rank other than 0 of the extractor's plan, after the re-extraction."""
    layer_names, train_meta, eval_meta, train_emb, eval_emb, global_labels = _prepare_run(
        cfg, extractor)
    if not _leads(extractor):
        return {}
    all_rows: list[dict] = []
    best_per_layer: dict[str, dict] = {}
    for layer in layer_names:
        logger.info("=== layer %s (grid) ===", layer)
        X_train, y_train, X_eval, y_eval, idx_to_label, class_names = _layer_data(
            layer, train_meta, eval_meta, train_emb, eval_emb, global_labels)
        check_data_quality(X_train, y_train)
        analyze_class_distribution(y_train, idx_to_label)

        grid = train_improved_models(
            X_train, y_train, X_eval, y_eval, class_names=class_names,
            smote_k_neighbors=cfg.smote_k_neighbors, random_state=cfg.random_state,
            model_names=model_names, include_smote=cfg.use_smote, device=cfg.device)
        out_dir = os.path.join(cfg.results_dir, layer)
        if cfg.make_plots:
            plots.plot_grid_comparison(grid, out_dir, tag=f"{layer}_model_comparison")
        best_key = max(grid, key=lambda k: grid[k]["balanced_accuracy"])
        best = grid[best_key]
        if cfg.make_plots:
            plots.plot_confusion_matrices(best["confusion_matrix"], class_names, out_dir,
                                          best_key)
        write_classification_report(best, out_dir, best_key)
        save_model(best["estimator"], out_dir, cfg.model_type, layer, best_key, best,
                   class_names=class_names)
        all_rows.extend(_result_row(layer, "configuration", key, r) for key, r in grid.items())
        best_per_layer[layer] = {k: v for k, v in best.items() if k != "estimator"}
        best_per_layer[layer]["configuration"] = best_key

    _finish(cfg, all_rows, best_per_layer)
    return best_per_layer
