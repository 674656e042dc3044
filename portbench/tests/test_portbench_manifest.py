"""``BENCHMARK.json`` against the contract's shapes, and every file the
harness finds by name."""

import json
import re

import pytest

from portbench.harness.manifest import Manifest
from portbench.tests._support import REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return Manifest(REPO)


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(manifest):
    spec = manifest.spec
    assert set(spec) == TOP_KEYS
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(spec["paths"]) <= 16
    for path in spec["paths"]:
        assert PATH.match(path) and not path.startswith("/") and ".." not in path.split("/")
        assert (REPO / path).is_dir()
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert all(_one_line(word) for word in spec["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(manifest, group):
    names = [entry["name"] for entry in manifest.spec[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(name) for name in names)


def test_metric_entries(manifest):
    spec = manifest.spec
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline_pct") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_workload_entries(manifest):
    spec = manifest.spec
    configs = {c["name"] for c in spec["configs"]}
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _one_line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(spec["workloads"])
    assert {w["config"] for w in spec["workloads"]} == configs
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(spec["workloads"]) // 4)


def test_config_entries(manifest):
    files = set()
    for c in manifest.spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://") and _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        config = manifest.config(c["name"])
        assert config["name"] == c["name"] and config["source"] == c["source"]


def test_every_cell_reports_enough(manifest):
    for w in manifest.spec["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(w["name"])
    for m in manifest.spec["per_layer"]:
        for name in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in manifest.end_to_end(name)}


def test_files_are_found_by_name(manifest):
    for w in manifest.spec["workloads"]:
        config = manifest.config(w["config"])
        traffic = manifest.traffic(w["traffic"])
        assert traffic["loop"] == "closed" and _one_line(traffic["why"])
        assert hasattr(manifest.reference(w["config"]), "run")
        assert hasattr(manifest.pipeline(config["pipeline"]), "Pipeline")
        limits = manifest.limits(w["name"])
        for name in ("stft_err", "loss_err", "filter_err", "wave_err"):
            entry = limits[name]
            # each limit lies between the readings it was set from
            assert entry["lower"] < entry["limit"] < entry["upper"]
    for m in manifest.spec["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    root = make_root(tmp_path)
    for path in (REPO / "portbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (root / path.relative_to(REPO)).read_bytes() == path.read_bytes()
    spec = json.loads((root / "BENCHMARK.json").read_text())
    assert spec["workloads"][: len(Manifest(REPO).spec["workloads"])] == Manifest(REPO).spec["workloads"]
    manifest = Manifest(root)
    assert manifest.traffic("small")["length_s"] == [2, 3]
    assert manifest.limits("auxiva_ip_c2.small")
