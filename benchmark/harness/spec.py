"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; the
configuration's file is given in `configs`, the mix is
`benchmark/traffic/<traffic>.json`, and each per-layer metric is read by
`benchmark/metrics/<name>.py` (dots in the name become underscores). A
later cell, mix or metric is one more entry and one more file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from . import traffic as traffic_mod

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
METRICS_DIR = BENCH_DIR / "metrics"


def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _reports(metric: dict, cell: str, spec: dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if metric in spec["end_to_end"]:
        return True
    moves = next(m for m in spec["end_to_end"] if m["name"] == metric["moves"])
    return _reports(moves, cell, spec)


def cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with its configuration, mix and metrics."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({[w['name'] for w in spec['workloads']]})")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=traffic_mod.load(entry["traffic"]),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name, spec)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name, spec)],
    )


def reader(metric_name: str):
    """The `read(run)` function of the per-layer metric `metric_name`."""
    path = METRICS_DIR / f"{metric_name.replace('.', '_')}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric_name!r} ({path})")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def build_dataclass(cls, values: dict):
    """An instance of the dataclass `cls` from its defaults and `values`:
    nested dataclasses from nested objects, lists as tuples where the field
    holds a tuple. A key that `cls` lacks raises."""
    base = cls()
    names = {f.name for f in dataclasses.fields(base)}
    unknown = sorted(set(values) - names)
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {unknown}")
    updates = {}
    for key, value in values.items():
        current = getattr(base, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = build_dataclass(type(current), value)
        elif isinstance(current, tuple) and isinstance(value, list):
            updates[key] = tuple(value)
        else:
            updates[key] = value
    return dataclasses.replace(base, **updates)
