"""BENCHMARK.json against the benchmark's contract and the harness's files,
and the imports of every module under port_bench/."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = os.path.join(ROOT, "port_bench")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["port_bench"] and bench["command"][1] == "port_bench/run.py"
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
            driver = json.load(f)["driver"]
        assert os.path.exists(os.path.join(HERE, "drivers", driver + ".py"))
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py")), m["name"]


def test_every_cell_reports_what_its_metrics_move(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in ws for n, ws in e2e.items() if n != "setup_s")
        assert any(cell in m["workloads"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]], (m["name"], cell)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _modules(under: str):
    for dirpath, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    forbidden = {"jax", "jaxlib", "flax", "rlobjectdetection_tpu"}
    seen = 0
    for path in _modules(HERE):
        names = _imports(path)
        assert not names & forbidden, (path, names & forbidden)
        seen += 1
    assert seen > 20
    # the names are compared whole: the port's name begins with the JAX package's
    assert "rlobjectdetection_tpu_torch" not in forbidden


def test_reference_imports_nothing_of_the_program():
    for path in _modules(os.path.join(HERE, "reference")):
        assert "rlobjectdetection_tpu_torch" not in _imports(path), path


def test_harness_files_outside_paths_are_not_named():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        command = json.load(f)["command"]
    for word in command:
        assert not word.startswith("/") and ".." not in word
