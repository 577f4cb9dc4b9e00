"""Where the harness finds each part of a cell, by the names that
``BENCHMARK.json`` gives:

* a configuration: its file of sizes (the entry's ``file``) and its builder
  ``benchmark/configs/<config>.py``;
* a traffic mix: ``benchmark/traffic/<traffic>.json``, parameters that one
  generator (:mod:`.traffic`) reads;
* a metric: its reader ``benchmark/metrics/<metric>.py``;
* the kernel families that roofline readers match:
  ``benchmark/kernels/*.py``.

A later change adds a cell, a mix, a metric or a kernel family by adding
files and entries; no file here names one.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = "benchmark"


class Layout:
    """The benchmark rooted at ``root`` (the directory that holds
    ``BENCHMARK.json``)."""

    def __init__(self, root):
        self.root = Path(root).resolve()
        self.dir = self.root / BENCH_DIR
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: Dict[Path, ModuleType] = {}

    def _entry(self, kind: str, name: str) -> dict:
        for e in self.spec[kind]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {kind} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str):
        """(entry, the configuration's file as a dict, its builder)."""
        entry = self._entry("configs", name)
        cfg = json.loads((self.root / entry["file"]).read_text())
        return entry, cfg, self.module(self.dir / "configs" / f"{name}.py")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics(self, workload: str, trace: bool) -> List[dict]:
        """The cell's metric entries: with ``trace`` its per-layer ones, else
        its end-to-end ones (an entry without ``workloads`` is every
        cell's)."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> ModuleType:
        return self.module(self.dir / "metrics" / f"{metric}.py")

    def kernel_families(self) -> List[ModuleType]:
        return [self.module(p)
                for p in sorted((self.dir / "kernels").glob("*.py"))
                if not p.name.startswith("_")]

    def module(self, path: Path) -> ModuleType:
        """Load the file at ``path`` as a module of its own (a file's name
        may hold dots, as a metric's does)."""
        path = Path(path)
        mod = self._modules.get(path)
        if mod is None:
            if not path.is_file():
                raise FileNotFoundError(f"{path} is missing")
            tag = hashlib.sha1(str(path).encode()).hexdigest()[:8]
            name = "_bench_" + re.sub(r"\W", "_", path.stem) + "_" + tag
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return mod


def family_patterns(families, metric: str) -> List[re.Pattern]:
    """The kernel name patterns of every family that names ``metric``."""
    return [re.compile(p) for f in families if metric in f.METRICS
            for p in f.PATTERNS]
