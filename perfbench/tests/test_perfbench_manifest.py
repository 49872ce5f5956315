"""BENCHMARK.json against the benchmark's contract, and the harness
finding a cell's files by name, a new cell and metric among them."""

from __future__ import annotations

import json
import pathlib
import re
import shutil

import pytest
import torch

from perfbench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
MANIFEST = harness.load_manifest(ROOT)
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", CELLS)


def test_keys_and_limits():
    m = MANIFEST
    assert set(m) == KEYS
    assert m["command"] == ["python3", "perfbench/run.py"]
    assert m["paths"] == ["perfbench"]
    assert 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits the check's time
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(m["configs"]) <= 24 and 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    m = MANIFEST
    names = [c["name"] for c in m["configs"]] + CELLS
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    names += [w["config"] for w in m["workloads"]] + [w["traffic"] for w in m["workloads"]]
    names += [k for c in m["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    assert len(set(CELLS)) == len(CELLS)
    for x in metrics:
        assert UNIT.match(x["unit"]), x
        assert x["better"] in ("lower", "higher")
    for text in [w["why"] for w in m["workloads"]] + [c["source"] for c in m["configs"]] + \
            [x["layer"] for x in m["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_exactly_the_contract_keys():
    m = MANIFEST
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in m["workloads"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_each_moves_is_reported_in_every_cell_of_its_metric():
    e2e = {x["name"]: x for x in MANIFEST["end_to_end"]}
    for x in MANIFEST["per_layer"]:
        assert x["moves"] in e2e and x["moves"] != "setup_s"
        for cell in x.get("workloads", CELLS):
            assert _reports(e2e[x["moves"]], cell), (x["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        e2e = [x["name"] for x in MANIFEST["end_to_end"] if _reports(x, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(x, cell) for x in MANIFEST["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_loader_finds_each_cells_files_by_name(cell):
    files = harness.cell_files(MANIFEST, cell, ROOT)
    assert files["driver"].is_file()
    assert files["config"]["name"] == files["cell"]["config"]
    assert all(path.is_file() for _, _, path in files["metrics"])
    names = {m["name"] for _, m, _ in files["metrics"]}
    assert "setup_s" in names


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.cell_files(MANIFEST, "no_such.cell", ROOT)


DUMMY_DRIVER = '''
import time
import torch


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.n, self.spans, self.host_spans = 0, None, None
        self.x = torch.full((traffic["size"],), float(seed % 7))

    def setup(self):
        pass

    def request(self):
        t0 = time.perf_counter()
        self.x = self.x * 0.5 + 1.0
        self.n += 1
        return time.perf_counter() - t0

    def counters(self):
        return {"requests": self.n}

    def attempted(self):
        return self.n

    def failed(self):
        return 0

    def release(self):
        pass

    def check(self):
        return [("fixed_point_gap", float((self.x - 2.0).abs().max()), 1e-3)]
'''


def test_a_cell_and_a_metric_added_as_new_files_only(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "perfbench"
    (bench / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps({"driver": "dummy", "size": 4}))
    (bench / "configs" / "dummy_config.json").write_text(json.dumps({"name": "dummy_config"}))
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(ctx):\n    return len(ctx['latencies_s'])\n")
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({"name": "dummy_config", "source": "https://example.org/dummy",
                         "file": "perfbench/configs/dummy_config.json", "reduced": [], "why": "test"})
    m["workloads"].append({"name": "dummy_config.dummy_mix", "config": "dummy_config",
                           "traffic": "dummy_mix", "chips": 1, "why": "test"})
    m["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["dummy_config.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    out, checks = harness.run("dummy_config.dummy_mix", 3, 0.05, False, root=tmp_path,
                              require_card=False, device=torch.device("cpu"))
    assert out["correct"] and checks[0][0] == "fixed_point_gap"
    assert out["metrics"]["requests_done"]["value"] == out["attempted"] > 0
    assert set(out["metrics"]) == {"requests_done", "setup_s"}


def test_no_card_refuses_before_any_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(harness.NoCard):
        harness.run(CELLS[0], 1, 0.1, False, root=ROOT)
