"""Whole runs of the harness on the CPU at a small size, skipping only its
look for a card: a sound run, a new metric added as a new file, the
control, and the faults that the comparison has to catch."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.tests._support import REPO, SMALL, cpu_process, cpu_run, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("portbench"))


def test_a_sound_run(root):
    rc, result, err = cpu_run(root, seconds=2, trace=0)
    assert rc == 0, err
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"audio_s_per_s", "sep_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "checks"
    checks = result["checks"]
    assert all(entry["value"] <= entry["limit"] for entry in checks.values())
    # the numbers compared end standard error, each beside its limit
    tail = err.strip().splitlines()[-len(checks):]
    assert [line.split()[1] for line in tail] == list(checks)


def test_a_traced_run_and_a_new_metric(root, tmp_path):
    reader = root / "portbench" / "metrics" / "recordings_traced.py"
    reader.write_text("def read(run):\n    return float(sum(r['profiled'] for r in run.recordings)) or None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "recordings_traced", "unit": "count", "better": "higher", "source": "program_counter",
                              "layer": "frontend", "moves": "audio_s_per_s", "workloads": [SMALL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        rc, result, err = cpu_run(root, seconds=3, trace=1)
    finally:
        spec["per_layer"].pop()
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        reader.unlink()
    assert rc == 0, err
    assert result["correct"] is True
    metrics = result["metrics"]
    assert metrics["recordings_traced"]["value"] >= 1
    assert metrics["frontend_ms"]["value"] > 0 and metrics["solve_ms"]["value"] > 0
    assert "solve_first_ms" in metrics
    # no device activity on the CPU: the device's metrics are left out
    assert "device_idle_pct" not in metrics and "ip_step_roofline_pct" not in metrics
    assert result["device"]["window_s"] > 0 and "breakdown" in result


@pytest.mark.parametrize("name", ["flax", "jaxlib"])
def test_a_reader_that_loads_jax_gives_no_result(root, name):
    # a per-layer reader runs after the window: what it loads is seen all
    # the same, and the run ends with 3 and prints no result
    package = root / name
    package.mkdir()
    (package / "__init__.py").write_text("")
    reader = root / "portbench" / "metrics" / "loads_jax.py"
    reader.write_text("def read(run):\n    import {}\n    return 1.0\n".format(name))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "loads_jax", "unit": "count", "better": "higher", "source": "program_counter",
                              "layer": "frontend", "moves": "audio_s_per_s", "workloads": [SMALL]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    try:
        proc = cpu_process(root, seconds=1, trace=1)
    finally:
        spec["per_layer"].pop()
        (root / "BENCHMARK.json").write_text(json.dumps(spec))
        reader.unlink()
        (package / "__init__.py").unlink()
        package.rmdir()
    assert proc.returncode == 3
    assert proc.stdout == ""
    assert "JAX or the JAX package was loaded: {}".format(name) in proc.stderr


@pytest.mark.parametrize("fault", ["unchanged_step", "half_frames", "altered_answer"])
def test_a_fault_is_not_correct(root, fault):
    rc, result, err = cpu_run(root, seconds=2, trace=0, fault=fault)
    assert rc == 0, err
    assert result["correct"] is False
    assert any(entry["value"] is None or entry["value"] > entry["limit"] for entry in result["checks"].values())


def test_the_control_is_not_correct():
    from portbench.harness import check
    from portbench.harness.cell import Cell
    from portbench.harness.manifest import Manifest

    manifest = Manifest(REPO)
    cell = Cell(manifest, "auxiva_ip_c2.clips_varlen", 2147483651, torch.device("cpu"))
    from portbench.reference import room

    cell.pool = room.recordings(2, 2, 48000, 16000, 2147483651, torch.device("cpu"))
    samples = [{"x": np.ascontiguousarray(p[:, :40000])} for p in cell.pool]
    numbers = check.compare(samples, cell.reference, cell.config, torch.device("cpu"), control=True)
    correct, table = check.judge(numbers, manifest.limits("auxiva_ip_c2.clips_varlen"))
    assert correct is False
    assert table["stft_err"]["value"] > table["stft_err"]["limit"]
    assert table["wave_err"]["value"] > table["wave_err"]["limit"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["auxiva_ip_c2.song_60s", "auxiva_ip_c2.clips_varlen"])
def test_a_short_run_on_the_card(card, workload):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload, "--seed", "2147483652", "--seconds", "2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert all(math.isfinite(m["value"]) for m in result["metrics"].values())
