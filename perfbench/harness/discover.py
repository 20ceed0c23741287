"""Finds a cell's pieces by the names in BENCHMARK.json, so that a new
configuration, traffic mix, cell or per-layer metric is a new file and
never an edit:

  configs/<config>.json       the sizes, as run (BENCHMARK.json's `file`);
                              either trunk may state `head_dim`, and the
                              draft `tie_word_embeddings: false` (a head
                              of its own)
  configs/<config>.py         `build(spec, seed, device, rows_per_slot)`
                              -> `coupled.Served`; where the block is not
                              one that `reference/model.py` and
                              `costs.py` compute, it also gives its own
                              per-trunk `reference` and `work`
                              (`coupled.Served`)
  reference/<name>.py         a configuration's own plain reference,
                              `logits(shape, model, seqs, wanted,
                              precision, device)`, loaded by its `.py`
                              with `reference(__file__, name)`
  traffic/<traffic>.json      the mix (`harness/traffic.py`)
  workloads/<cell>.json       the engine's settings, the check's sample
                              and the limits of `correct`
  metrics/<metric>.py         `read(ctx)` of one per-layer metric
                              (`cell.context`: spans, device time by
                              span and by kernel name, work)
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def reference(config_py: str, name: str):
    """The module `reference/<name>.py` of the benchmark that holds the
    configuration file `config_py` (a configuration's `.py` passes its
    `__file__`)."""
    path = Path(config_py).resolve().parents[1] / "reference" / f"{name}.py"
    return _load(path, "perfbench_reference_" + _ident(name))


class Bench:
    def __init__(self, root: Path, pkg: Path):
        self.root, self.pkg = Path(root), Path(pkg)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def workload(self, cell: str) -> dict:
        """BENCHMARK.json's entry of the cell, with its file's settings."""
        entry = next((w for w in self.spec["workloads"] if w["name"] == cell),
                     None)
        if entry is None:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
        with open(self.pkg / "workloads" / f"{cell}.json") as f:
            return dict(json.load(f), **entry)

    def config(self, name: str):
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        with open(self.root / entry["file"]) as f:
            spec = json.load(f)
        path = (self.root / entry["file"]).with_suffix(".py")
        return spec, _load(path, "perfbench_config_" + _ident(name))

    def traffic(self, name: str) -> dict:
        with open(self.pkg / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metric(self, name: str):
        return _load(self.pkg / "metrics" / f"{name}.py",
                     "perfbench_metric_" + _ident(name))

    def metrics_of(self, cell: str, kind: str):
        """The cell's end_to_end or per_layer metrics: those that list it,
        or list no cells."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]
