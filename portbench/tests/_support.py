"""Helpers of the harness's CPU tests: a checkout copy with a small cell
added as new files, and a whole run of it in a fresh process."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PROGRAM = "audio_source_separation_tpu_torch"

# a small cell of the main path's configuration: 2-3 s clips, short
# enough for the CPU
SMALL = "auxiva_ip_c2.small"
SMALL_TRAFFIC = {
    "loop": "closed",
    "clients": 1,
    "length_s": [2, 3],
    "pool": 2,
    "warmup_s": 1,
    "trace_recordings": 2,
    "check_recordings": 2,
    "why": "short clips for the CPU tests",
}


def make_root(tmp_path):
    """A checkout copy under ``tmp_path``: ``BENCHMARK.json``, ``portbench``
    and the program, with the small cell added as new files and a new entry
    (its traffic, its limits: the clip cell's)."""
    root = Path(tmp_path) / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / PROGRAM, root / PROGRAM)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append(
        {"name": SMALL, "config": "auxiva_ip_c2", "traffic": "small", "chips": 1, "why": "short clips for the CPU tests"}
    )
    for metric in spec["per_layer"]:
        if "workloads" in metric and "auxiva_ip_c2.clips_varlen" in metric["workloads"]:
            metric["workloads"].append(SMALL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    (root / "portbench" / "traffic" / "small.json").write_text(json.dumps(SMALL_TRAFFIC))
    shutil.copy(
        root / "portbench" / "limits" / "auxiva_ip_c2.clips_varlen.json", root / "portbench" / "limits" / (SMALL + ".json")
    )
    return root


def cpu_process(root, workload=SMALL, seed=2147483649, seconds=2, trace=0, fault=None, timeout=300):
    """The finished process of a whole run of the harness in ``root`` on
    the CPU (:mod:`portbench.tests.cpu_run`)."""
    cmd = [sys.executable, "-m", "portbench.tests.cpu_run", "--root", str(root), "--workload", workload]
    cmd += ["--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    if fault:
        cmd += ["--fault", fault]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout, env=env)


def cpu_run(root, **kwargs):
    """``(exit code, result or None, stderr)`` of :func:`cpu_process`."""
    proc = cpu_process(root, **kwargs)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return proc.returncode, result, proc.stderr
