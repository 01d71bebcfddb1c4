"""The benchmark's harness: one run of one cell, driven by data.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix and each metric, and the file of each configuration (``configs/*.json``:
the model's sizes, its ``family``, its preset and the limits of the numbers
that decide ``correct``). Everything else is found by name under the
benchmark's folder:

- ``families/<family>.py``: the program's model and extractor for that
  family, and its plain reference (``reference/``);
- ``traffic/<mix>.json``: the mix's parameters, and the ``entry`` that
  drives it;
- ``entries/<entry>.py``: ``run(ctx)`` drives the program through set-up,
  the window and, with ``--trace 1``, a profiled stretch, and returns a
  record; ``check(ctx, record)`` returns the numbers that decide
  ``correct``;
- ``metrics/<metric>.py``: ``read(run)`` takes one metric from the record,
  or returns None where it finds nothing to read.

An untraced run of a cell with an end-to-end metric taken from the device
trace has ``ctx.profile_window`` set: the entry records the device's work
over its window.

A new cell, mix, configuration or metric is new files and entries; no
file here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType

from benchmark.faults import FAULTS

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stutter_tpu")


def load_module(path: Path) -> ModuleType:
    """The module at ``path`` (metric names hold dots, so not by import)."""
    spec = importlib.util.spec_from_file_location(f"_bench_{path.stem}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """One run: the cell's data, the seed and the device, and the clocks."""

    cell: dict
    config: dict
    traffic: dict
    family: ModuleType
    seed: int
    seconds: float
    trace: bool
    device: object
    workdir: Path
    preset: str
    control: bool
    started: float
    profile_window: bool = False
    setup_s: float | None = None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_started(self) -> None:
        self.setup_s = time.perf_counter() - self.started


@dataclasses.dataclass
class Run:
    """What a metric reader sees: the context and the entry's record."""

    ctx: Context
    record: dict


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric without ``workloads`` is every cell's."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             started: float, device=None, control: bool = False, fault: str | None = None,
             bench_dir: Path = BENCH_DIR) -> tuple[dict, dict]:
    """Run one cell once. Returns (result line, notes for standard error).
    ``device`` None means the first card. ``control`` runs the cell's
    control, the program's int8 path, in place of the configuration's
    precision: the configuration's ``control_preset`` in extraction and
    serving, ``int8_forward`` (the same W8A8 products) in fine-tuning.
    ``fault`` plants one of ``faults.FAULTS`` in the program."""
    import torch

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf_entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    family = load_module(bench_dir / "families" / f"{config['family']}.py")
    entry = load_module(bench_dir / "entries" / f"{traffic['entry']}.py")
    readers = {m["name"]: load_module(bench_dir / "metrics" / f"{m['name']}.py")
               for m in cell_metrics(bench, workload, trace)}

    if device is None:
        device = torch.device("cuda", 0)
    device = torch.device(device)
    workdir = Path(tempfile.mkdtemp(prefix=f"bench-{workload}-"))
    ctx = Context(cell=cell, config=config, traffic=traffic, family=family, seed=seed,
                  seconds=seconds, trace=trace, device=device, workdir=workdir,
                  preset=config["control_preset" if control else "preset"], control=control,
                  started=started, profile_window=not trace and device.type == "cuda" and any(
                      m["source"] == "device_trace" for m in cell_metrics(bench, workload, False)))
    undo = FAULTS[fault]() if fault else None
    try:
        record = entry.run(ctx)
        peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
        run = Run(ctx, record)
        metrics = {}
        for m in cell_metrics(bench, workload, trace):
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if device.type == "cuda":  # the reference runs after the program's state is freed
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers = entry.check(ctx, record)
        check_s = time.perf_counter() - t0
        written = bytes_written()
    finally:
        if undo is not None:
            undo()
        shutil.rmtree(workdir, ignore_errors=True)
    limits = config["check"]["limits"]
    checks = {name: {"value": value, "limit": limits[name]} for name, value in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": cell["chips"], "memory_peak_bytes": peak}
    if trace and "trace" in record:
        device_info["busy_s"] = record["trace"].busy_s
        device_info["window_s"] = record["trace"].window_s
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics, "device": device_info}
    if trace and "trace" in record:
        result["breakdown"] = {"device_ops": record["trace"].device_ops,
                               "idle_gaps": record["trace"].idle_gaps}
    result["checks"] = checks
    return result, {"bytes_written": written, "setup_s": ctx.setup_s, "check_s": check_s,
                    **record.get("notes", {})}


def bytes_written() -> dict:
    """This process's bytes written so far (Linux): ``wchar`` counts every
    write call, ``write_bytes`` what reached a block device."""
    try:
        with open(f"/proc/{os.getpid()}/io") as f:
            fields = dict(line.split(": ") for line in f.read().splitlines())
    except OSError:
        return {}
    return {k: int(fields[k]) for k in ("wchar", "write_bytes") if k in fields}
