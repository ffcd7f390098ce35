"""What the benchmark runs, found by name: the cells, configurations, traffic
mixes and metric readers that ``BENCHMARK.json`` lists.

- a configuration is the JSON file its entry names (``file``), with the
  plain reference its ``reference`` key names (``<module>.<Class>`` under
  ``benchmark/reference/``);
- a traffic mix is ``benchmark/traffic/<traffic>.json``;
- a metric is ``benchmark/metrics/<name>.py``, whose ``read(reading)``
  returns the number, or ``None`` where the run has nothing to read.

A later cell, mix or metric is new files and new entries; no code here
names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict       # the configuration file's contents
    traffic: dict      # the traffic file's contents
    end_to_end: tuple  # metric entries of BENCHMARK.json this cell reports
    per_layer: tuple


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {', '.join(sorted(cells))}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / entry["file"]).read_text()),
        traffic=json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of the metric ``name``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference(config: dict, device):
    """The plain reference of ``config`` on ``device``."""
    module, cls = config["reference"].rsplit(".", 1)
    return getattr(importlib.import_module(f"benchmark.reference.{module}"), cls)(config, device)
