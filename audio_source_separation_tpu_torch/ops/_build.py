"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``.  Libraries go to
``build/kernels/`` beside the package (listed in ``.gitignore``), named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.
Nothing is built at import time: the first CUDA launch of a kernel builds
it, and :func:`build_all` builds every kernel at once, one ``nvcc``
process per source, all started together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

SOURCES = {
    "weighted_covariance": "weighted_covariance.cu",
    "fused_auxiva_ip": "fused_auxiva_ip.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded = {}


def nvcc_path():
    """The CUDA compiler: ``nvcc`` on ``PATH``, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found; the CUDA toolkit is needed to build the kernels")


def library_path(name):
    """Path of the shared library for kernel ``name`` (may not exist yet),
    named by a hash of its source, every shared header and the flags."""
    hasher = hashlib.sha256()
    for path in [CSRC_DIR / SOURCES[name], *sorted(CSRC_DIR.glob("*.cuh"))]:
        hasher.update(path.name.encode() + b"\0" + path.read_bytes())
    hasher.update(" ".join(NVCC_FLAGS).encode())
    digest = hasher.hexdigest()[:16]
    return BUILD_DIR / "lib{}-{}.so".format(name, digest)


def build_all(names=None, verbose=False):
    """Compile every kernel in ``names`` (default: all) that is not built
    yet, one ``nvcc`` per source in parallel.

    Returns ``{name: compiler output}`` for the kernels built by this call;
    ``verbose=True`` adds ``-Xptxas -v`` so the output lists each kernel's
    registers and shared memory.  Raises ``RuntimeError`` if a build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(".so.tmp{}".format(os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
        )
    outputs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        outputs[name] = out
        if proc.returncode != 0:
            failed.append("{} (exit {}):\n{}".format(name, proc.returncode, out))
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return outputs


def load(name):
    """The ``ctypes`` library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check(status, name):
    """Raise if a kernel's C entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(name, status))
