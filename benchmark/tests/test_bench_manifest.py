"""``BENCHMARK.json`` against the benchmark's contract, the harness
finding new cells and metrics by name, and the isolation of what a run
imports."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.core import Manifest, Measure

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
FORBIDDEN = {"jax", "jaxlib", "flax", "disq_tpu"}


@pytest.fixture(scope="module")
def doc(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys_names_and_units(doc, root):
    assert set(doc) == KEYS["top"]
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= doc["run_seconds"] <= 51 and isinstance(doc["run_seconds"], int)
    assert 1 <= len(doc["paths"]) <= 16
    for p in doc["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(doc["command"]) <= 32 and all(_line(w) for w in doc["command"])
    for kind, items in (("config", doc["configs"]),
                        ("workload", doc["workloads"])):
        names = [i["name"] for i in items]
        assert len(names) == len(set(names))
        for item in items:
            assert set(item) == KEYS[kind], item["name"]
            assert NAME.match(item["name"]) and _line(item["why"])
    metric_names = []
    for kind in ("end_to_end", "per_layer"):
        for m in doc[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m["name"]
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            metric_names.append(m["name"])
    assert len(metric_names) == len(set(metric_names))
    for c in doc["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(doc["paths"][0] + "/")
    for w in doc["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in doc["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])


def test_every_cell_on_one_chip_reports_what_it_must(doc, root):
    man = Manifest(root)
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in doc["workloads"]:
        assert w["chips"] == 1
        reported = {m["name"] for m in man.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert man.per_layer(w["name"]), w["name"]
    for m in doc["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in doc["workloads"]}
            assert cell in e2e[m["moves"]].get("workloads", [cell]), \
                f"{m['name']}: {cell} does not report {m['moves']}"
    for m in doc["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_named_file_is_there(doc, root):
    man = Manifest(root)
    for w in doc["workloads"]:
        wl = man.workload(w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(root, "benchmark", "jobs",
                                           f"{wl['kind']}.py"))
        cfg = man.config(w["config"])
        assert os.path.exists(os.path.join(
            root, "benchmark", "generators", f"{cfg['generator']}.py"))
        assert set(cfg["reduced"]) == set(
            next(c for c in doc["configs"]
                 if c["name"] == w["config"])["reduced"])
    for m in doc["per_layer"]:
        assert callable(man.reader(m["name"]).read)


def test_new_cell_config_and_metric_are_found_as_files(root, tmp_path):
    """A cell, a configuration and a per-layer metric added as new files
    (and entries in BENCHMARK.json) are found by name, with no edit of a
    file the benchmark already has."""
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(root, "benchmark"), copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.load(open(os.path.join(root, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (copy / "benchmark").rglob("*") if x.is_file())}
    cfg = json.load(open(copy / "benchmark/configs/wgs-unsorted.json"))
    cfg["name"] = "wgs-unsorted-small"
    (copy / "benchmark/configs/wgs-unsorted-small.json").write_text(
        json.dumps(cfg))
    (copy / "benchmark/workloads/bam-sort-write-small.json").write_text(json.dumps(
        {"name": "bam-sort-write-small", "config": "wgs-unsorted-small",
         "traffic": "sort_write", "kind": "sort_write",
         "why": "a smaller sort and write"}))
    (copy / "benchmark/metrics/passes.write.py").write_text(
        "def read(m):\n    return m.facts.get('passes')\n")
    doc["configs"].append({"name": "wgs-unsorted-small", "source": "x",
                           "file": "benchmark/configs/wgs-unsorted-small.json",
                           "reduced": ["reads"], "why": "x"})
    doc["workloads"].append({"name": "bam-sort-write-small",
                             "config": "wgs-unsorted-small",
                             "traffic": "sort_write", "chips": 1, "why": "x"})
    for m in doc["end_to_end"]:
        if m["name"] == "write_rate":
            m["workloads"].append("bam-sort-write-small")
    doc["per_layer"].append({"name": "passes.write", "unit": "passes",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "write_rate",
                             "workloads": ["bam-sort-write-small"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(doc))
    man = Manifest(str(copy), str(copy / "benchmark"))
    assert man.cell("bam-sort-write-small")["config"] == "wgs-unsorted-small"
    assert man.config("wgs-unsorted-small")["name"] == "wgs-unsorted-small"
    assert man.workload("bam-sort-write-small")["kind"] == "sort_write"
    assert [m["name"] for m in man.per_layer("bam-sort-write-small")] == \
        ["passes.write"]
    assert man.reader("passes.write").read(Measure(facts={"passes": 7})) == 7
    assert {m["name"] for m in man.end_to_end("bam-sort-write-small")} == \
        {"setup_s", "write_rate"}
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


def _sources(root, sub):
    base = os.path.join(root, "benchmark", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package(root):
    for path in _sources(root, ""):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program(root):
    allowed = {"numpy", "zlib", "struct", "os", "typing", "dataclasses",
               "concurrent", "__future__", "benchmark"}
    for path in _sources(root, "reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in allowed, (path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path, name)


def test_a_checkout_of_the_benchmark_alone_prints_no_result(root, tmp_path):
    shutil.copytree(os.path.join(root, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bam-sort-write",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
