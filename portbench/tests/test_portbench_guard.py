"""What the benchmark may load, and the run without a card."""

import subprocess
import sys

from portbench.harness import guard
from portbench.tests._support import REPO


def test_whole_top_level_names():
    modules = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "audio_source_separation_tpu.ops": 1, "jaxtyping": 1,
               "audio_source_separation_tpu_torch": 1, "audio_source_separation_tpu_torch.ops": 1, "flaxen": 1}
    assert guard.loaded(guard.FORBIDDEN, modules) == ["audio_source_separation_tpu.ops", "jax", "jax.numpy", "jaxlib.xla"]
    assert guard.loaded([guard.PROGRAM], modules) == ["audio_source_separation_tpu_torch", "audio_source_separation_tpu_torch.ops"]


def test_the_references_import_nothing_of_the_program():
    assert guard.reference_faults(REPO / "portbench" / "reference") == []


def test_a_reference_import_is_found(tmp_path):
    (tmp_path / "bad.py").write_text("def f():\n    from audio_source_separation_tpu_torch.ops import fused_ip\n")
    (tmp_path / "worse.py").write_text("import jax.numpy as jnp\n")
    assert guard.reference_faults(tmp_path) == [("bad.py", guard.PROGRAM), ("worse.py", "jax")]


def test_loading_the_harness_and_references_loads_no_program():
    code = (
        "import sys; sys.path.insert(0, {!r});"
        "from portbench.harness import cell, check, guard, manifest, runner, trace, traffic;"
        "from portbench.reference import auxiva_ip_c2, common, room;"
        "print(guard.loaded(guard.FORBIDDEN + (guard.PROGRAM,)))"
    ).format(str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "auxiva_ip_c2.song_60s", "--seed", "2147483650", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr
