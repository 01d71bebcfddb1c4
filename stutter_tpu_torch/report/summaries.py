"""Text and CSV summaries (counterpart of ``stutter_tpu/report/summaries.py``; reference C19).

The reference's artifacts: ``{tag}_classification_report.txt``
(``model_training_01.py:835-852``), ``all_results_comparison.csv`` and
``layer_comparison_summary.csv`` (``model_training_01.py:875-933``,
``model_training_1.py:1020-1075``) and ``final_summary.txt``
(``model_training_01.py:946-966``). The CSVs are written with the ``csv``
module as ``DataFrame.to_csv(index=False)`` writes them: the columns in
order of first appearance, a missing value empty.
"""

from __future__ import annotations

import csv
import logging
import os

from stutter_tpu_torch.extract.store import csv_cell
from stutter_tpu_torch.train.metrics import classification_report_text

logger = logging.getLogger("stutter_tpu_torch.report.summaries")


def write_classification_report(metrics: dict, out_dir: str, tag: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}_classification_report.txt")
    with open(path, "w") as f:
        f.write(f"Classification report — {tag}\n\n")
        f.write(classification_report_text(metrics))
        f.write("\n")
    return path


def write_comparison_csv(rows: list[dict], out_dir: str,
                         filename: str = "all_results_comparison.csv") -> str:
    """Flat CSV of every (layer, classifier, dataset) result row."""
    os.makedirs(out_dir, exist_ok=True)
    columns = list(dict.fromkeys(c for row in rows for c in row))
    path = os.path.join(out_dir, filename)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([csv_cell(row.get(c)) for c in columns])
    logger.info("wrote %s (%d rows)", path, len(rows))
    return path


def write_layer_summary(layer_results: dict[str, dict], out_dir: str,
                        filename: str = "layer_comparison_summary.csv") -> str:
    rows = [{"layer": layer,
             "best_classifier": r.get("classifier", r.get("model", "")),
             "accuracy": r.get("accuracy"),
             "balanced_accuracy": r.get("balanced_accuracy"),
             "weighted_f1": r.get("weighted_f1"),
             "macro_f1": r.get("macro_f1")}
            for layer, r in layer_results.items()]
    return write_comparison_csv(rows, out_dir, filename)


def write_final_summary(best_layer: str, best_results: dict, all_layers: dict[str, dict],
                        out_dir: str, model_type: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "final_summary.txt")
    best_clf = best_results.get("classifier", best_results.get("model", ""))
    with open(path, "w") as f:
        f.write("=== Final training summary ===\n\n")
        f.write(f"model_type: {model_type}\n")
        f.write(f"layers evaluated: {list(all_layers)}\n\n")
        f.write(f"BEST layer: {best_layer}\n")
        f.write(f"  classifier:        {best_clf}\n")
        f.write(f"  balanced accuracy: {best_results['balanced_accuracy']:.4f}\n")
        f.write(f"  accuracy:          {best_results['accuracy']:.4f}\n")
        f.write(f"  weighted F1:       {best_results['weighted_f1']:.4f}\n")
        f.write(f"  macro F1:          {best_results['macro_f1']:.4f}\n\n")
        f.write("Per-layer best balanced accuracy:\n")
        for layer, r in all_layers.items():
            f.write(f"  {layer:>24}: {r['balanced_accuracy']:.4f}\n")
    logger.info("wrote %s", path)
    return path
