"""``BENCHMARK.json`` and the files the harness finds by name in it.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own:

  * a configuration: its ``file`` (a JSON object: sizes, the system's
    entry, what was taken from the source and what was assumed) and its
    plain reference ``portbench/reference/<config>.py``;
  * a traffic mix: ``portbench/traffic/<traffic>.json``
    (:mod:`~portbench.harness.traffic`);
  * a per-layer metric: its reader ``portbench/metrics/<metric>.py``,
    whose ``read(run)`` returns a number or ``None``;
  * a cell: the limits of its comparison, ``portbench/limits/<cell>.json``;
  * a configuration's path through the program: the pipeline that its
    file names, ``portbench/pipelines/<pipeline>.py``.

So a new cell, traffic mix, metric or configuration is new files and new
entries in ``BENCHMARK.json``, with no edit to a file that is there.
"""

import importlib
import importlib.util
import json
from pathlib import Path

PACKAGE = "portbench"


class Manifest:
    def __init__(self, root):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.home = self.root / PACKAGE

    @staticmethod
    def _named(entries, name, kind):
        for entry in entries:
            if entry["name"] == name:
                return entry
        raise KeyError("BENCHMARK.json has no {} named {!r}".format(kind, name))

    def workload(self, name):
        return self._named(self.spec["workloads"], name, "workload")

    def config(self, name):
        entry = self._named(self.spec["configs"], name, "config")
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name):
        return json.loads((self.home / "traffic" / (name + ".json")).read_text())

    def limits(self, workload):
        return json.loads((self.home / "limits" / (workload + ".json")).read_text())

    def reference(self, config):
        return importlib.import_module("{}.reference.{}".format(PACKAGE, config))

    def pipeline(self, name):
        return importlib.import_module("{}.pipelines.{}".format(PACKAGE, name))

    def reader(self, metric):
        """The reader module of a per-layer metric (loaded from its file,
        since a metric's name may hold dots)."""
        path = self.home / "metrics" / (metric + ".py")
        spec = importlib.util.spec_from_file_location("{}.metrics.{}".format(PACKAGE, metric.replace(".", "_")), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def end_to_end(self, workload):
        """The cell's end-to-end metrics: those that list it, and those that
        list no cells."""
        return [m for m in self.spec["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload):
        """The cell's per-layer metrics: those that list it, and those that
        list no cells and move an end-to-end metric that it reports."""
        reported = {m["name"] for m in self.end_to_end(workload)}
        out = []
        for m in self.spec["per_layer"]:
            listed = m.get("workloads")
            if (listed is not None and workload in listed) or (listed is None and m["moves"] in reported):
                out.append(m)
        return out
