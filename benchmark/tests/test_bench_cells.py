"""Configurations, traffic mixes and metric readers are found by the names
in BENCHMARK.json, a new one as new files only."""

import json
import re
import shutil

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_entry_resolves():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        cell = cells.find_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["num_envs"] > 0
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m in (*cell.end_to_end, *cell.per_layer):
            assert callable(cells.reader(m["name"]))
    for m in (*bench["end_to_end"], *bench["per_layer"]):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    with pytest.raises(KeyError):
        cells.find_cell("no-such-cell")


def test_reference_found_by_name():
    cell = cells.find_cell("walker3d-custom.b131072")
    ref = cells.reference(cell.config, "cpu")
    assert (ref.act_dim, ref.obs_dim) == (cell.config["widths"]["act_dim"],
                                          cell.config["widths"]["obs_dim"])


def test_a_new_cell_mix_and_metric_are_new_files(tmp_path):
    root = tmp_path
    (root / "benchmark").mkdir()
    shutil.copy(cells.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(cells.HERE / sub, root / "benchmark" / sub)
    config = json.loads((root / "benchmark/configs/walker3d-custom.json").read_text())
    config["name"] = "extra-walker"
    (root / "benchmark/configs/extra-walker.json").write_text(json.dumps(config))
    mix = json.loads((root / "benchmark/traffic/rollout-b32768.json").read_text())
    mix["num_envs"] = 4096
    (root / "benchmark/traffic/rollout-b4096.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/extra_metric.train.py").write_text(
        "def read(reading):\n    return 42.0 if reading is None else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "extra-walker", "source": "s", "reduced": [], "why": "w",
                             "file": "benchmark/configs/extra-walker.json"})
    bench["workloads"].append({"name": "extra-walker.b4096", "config": "extra-walker",
                               "traffic": "rollout-b4096", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "extra_metric.train", "unit": "%", "better": "higher",
                               "source": "program_span", "layer": "kernel",
                               "moves": "env_steps_per_s", "workloads": ["extra-walker.b4096"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.find_cell("extra-walker.b4096", root=root)
    assert cell.config["name"] == "extra-walker" and cell.traffic["num_envs"] == 4096
    assert [m["name"] for m in cell.per_layer][-1] == "extra_metric.train"
    assert cells.reader("extra_metric.train", root=root)(None) == 42.0
    # the metric is the new cell's only: the existing cells do not report it
    old = cells.find_cell("walker3d-custom.b131072", root=root)
    assert "extra_metric.train" not in {m["name"] for m in old.per_layer}
    with pytest.raises(FileNotFoundError):
        cells.reader("not_there", root=root)
