"""What the benchmark may load.

Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the program.  Module names are compared by
their whole top-level name (the part before the first dot): the port's
name begins with the JAX package's, so a prefix test would match it.
"""

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "audio_source_separation_tpu")
PROGRAM = "audio_source_separation_tpu_torch"


def top_level(name):
    return name.partition(".")[0]


def loaded(names, modules=None):
    """The modules in ``modules`` (default ``sys.modules``) whose top-level
    name is one of ``names``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if top_level(m) in names)


def forbidden_loaded():
    """The loaded modules of JAX and the JAX package."""
    return loaded(FORBIDDEN)


def imported_names(path):
    """Top-level names of every module that the Python file at ``path``
    imports, at any depth of its code; a relative import gives ``"."``."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(top_level(alias.name) for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else top_level(node.module))
    return names


def reference_faults(reference_dir):
    """``[(file, name)]`` for each import of the program, JAX or the JAX
    package in the plain references' sources."""
    faults = []
    for path in sorted(Path(reference_dir).glob("*.py")):
        for name in imported_names(path):
            if name in FORBIDDEN or name == PROGRAM:
                faults.append((path.name, name))
    return faults
