"""The benchmark's own files, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file the
entry of ``configs`` gives (``configs/<name>.json``: the deployment's
sizes and guarantees), and a traffic mix (``traffic/<mix>.json``: the
parameters of the one generator in :mod:`ecbench.ops`, with the name of
the operation, ``ops/<op>.py``, that makes and judges its calls). Every
metric has a reader of its own, ``metrics/<metric>.py``, with one
function ``read(run)`` that returns the value or None when the run has
nothing to read. So a configuration, a mix, an operation or a metric is
added as a new file and a new entry, and no file here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (no ``workloads``: all do)."""
    return cell in metric.get("workloads", [cell])


def cell(name: str, benchmark: Path = BENCHMARK) -> Cell:
    """The cell ``name`` with its configuration and traffic loaded."""
    spec = load_json(benchmark)
    entry = {w["name"]: w for w in spec["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {benchmark.name}; known: "
                       f"{sorted(w['name'] for w in spec['workloads'])}")
    conf = {c["name"]: c for c in spec["configs"]}[entry["config"]]
    return Cell(
        name=name, chips=entry["chips"],
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if reports(m, name)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"ecbench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
