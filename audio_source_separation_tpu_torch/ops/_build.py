"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with ``ctypes``.  Libraries go to
``build/kernels/`` beside the package (listed in ``.gitignore``), named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and an unchanged one is reused.
Nothing is built at import time: the first CUDA launch of a kernel builds
it, and :func:`build_all` builds every kernel at once, one ``nvcc``
process per source, all started together.  :func:`hashed_library` and
:func:`build_shared` serve the host-side C library of ``runtime/native.py``
too, which ``cc`` builds into ``build/native/``.
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
    "batched_eigh": "batched_eigh.cu",
    "fastmnmf_rows": "fastmnmf_rows.cu",
    "fastmnmf_mu": "fastmnmf_mu.cu",
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


def hashed_library(build_dir, name, inputs, flags):
    """``build_dir/lib<name>-<hash>.so`` (may not exist yet), named by a hash
    of every input file (name and bytes) and the flags."""
    hasher = hashlib.sha256()
    for path in inputs:
        hasher.update(path.name.encode() + b"\0" + path.read_bytes())
    hasher.update(" ".join(flags).encode())
    return Path(build_dir) / "lib{}-{}.so".format(name, hasher.hexdigest()[:16])


def library_path(name):
    """Path of the shared library for kernel ``name``, named by a hash of
    its source, every shared header and the flags."""
    inputs = [CSRC_DIR / SOURCES[name], *sorted(CSRC_DIR.glob("*.cuh"))]
    return hashed_library(BUILD_DIR, name, inputs, NVCC_FLAGS)


def build_shared(jobs):
    """Compile each job ``name: (command, source, target)`` into a shared
    library, one process per job, all started together: ``command`` is the
    compiler and its flags, the source and ``-o`` are added.  Each library is
    written to a temporary file and moved onto ``target`` once built, so a
    reader never sees a partial one.

    Returns ``({name: compiler output}, [failure report])``; a compiler that
    cannot be started raises ``OSError``.
    """
    procs = {}
    for name, (command, source, target) in jobs.items():
        Path(target).parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(".so.tmp{}".format(os.getpid()))
        cmd = [*command, "-o", str(tmp), str(source)]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
        )
    outputs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        outputs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append("{} (exit {}):\n{}".format(name, proc.returncode, outputs[name]))
            continue
        os.replace(tmp, target)
    return outputs, failed


def build_all(names=None, verbose=False):
    """Compile every kernel in ``names`` (default: all) that is not built
    yet, one ``nvcc`` per source in parallel.

    Returns ``{name: compiler output}`` for the kernels built by this call;
    ``verbose=True`` adds ``-Xptxas -v`` so the output lists each kernel's
    registers and shared memory.  Raises ``RuntimeError`` if a build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    command = [nvcc_path(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ())]
    jobs = {
        name: (command, CSRC_DIR / SOURCES[name], library_path(name))
        for name in names
        if not library_path(name).exists()
    }
    outputs, failed = build_shared(jobs)
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
