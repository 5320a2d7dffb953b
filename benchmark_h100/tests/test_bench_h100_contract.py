"""``BENCHMARK.json`` against the shape the benchmark's readers expect, and
the harness's behaviour without a card and without the program."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark_h100 import harness

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("section", list(KEYS))
def test_names_units_and_keys(section):
    entries = BENCH[section]
    assert len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end":
                assert TEXT.match(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", ()):
            assert NAME.match(key)


def test_cells_metrics_and_files():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert harness.applies(e2e[m["moves"]], {"name": cell}), (m["name"], cell)
        assert (REPO / "benchmark_h100" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert (REPO / "benchmark_h100" / "metrics" / f"{m['name']}.py").exists()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and TEXT.match(w["why"])
        assert (REPO / "benchmark_h100" / "traffic" / f"{w['traffic']}.json").exists()
        reported = [m for m in BENCH["end_to_end"] if harness.applies(m, w)]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(harness.applies(m, w) for m in BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark_h100/") and (REPO / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]


def _run(cwd: Path, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "benchmark_h100/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run(REPO, "--workload", "slice2d.gen.sweep155.ddim50", "--seed", str(2**31 + 7),
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark_h100", tmp_path / "benchmark_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "slice2d.gen.sweep155.ddim50", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
