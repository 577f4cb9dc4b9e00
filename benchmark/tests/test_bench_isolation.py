"""What the benchmark may load, and where it refuses to run.

* A rehearsal of each cell's run, in a process of its own on the CPU at a
  tiny size, leaves no ``jax``, ``jaxlib``, ``flax`` or top-level
  ``pyneuralempc_tpu`` (the JAX package; compared by whole top-level
  names) in ``sys.modules``.
* The plain reference imports nothing of the package under test.
* The harness refuses a checkout whose package under test is not its own,
  and ``run.py`` exits non-zero without printing a result where it has no
  card or no package.
"""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import driver

from conftest import CELLS, ROOT, TINY

REHEARSAL = """
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark.harness import env
env.setup(__import__("pathlib").Path({root!r}))
import torch
torch.set_num_threads(1)
from benchmark.harness import driver
from benchmark.harness.layout import Layout
res = driver.run(Layout({root!r}), {cell!r}, 4242, 0.3, True,
                 t_start=time.perf_counter(), device="cpu",
                 overrides=json.loads({over!r}))
print(json.dumps({{"correct": res["correct"],
                   "found": driver.forbidden_modules(),
                   "port": "pyneuralempc_tpu_torch" in sys.modules}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_loads_no_jax(cell):
    code = REHEARSAL.format(root=str(ROOT), cell=cell,
                            over=json.dumps(TINY[cell]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "found": [], "port": True}


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.quadrotor\n"
            "import benchmark.reference.nlp\n"
            "import benchmark.reference.sweep_counts\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pyneuralempc_tpu_torch', 'pyneuralempc_tpu', 'jax')))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyneuralempc_tpu_torch_extra",
                        sys.modules[__name__])
    assert driver.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pyneuralempc_tpu.core",
                        sys.modules[__name__])
    assert driver.forbidden_modules() == ["pyneuralempc_tpu.core"]


def test_refuses_a_package_from_elsewhere(tmp_path):
    with pytest.raises(driver.Refused) as e:
        driver.import_port(tmp_path)
    assert e.value.code == 3


def test_run_prints_nothing_in_a_bare_checkout(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: no
    result, a non-zero exit (here the CPU sandbox's missing card, on the
    chip the missing package)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert out.stdout == ""
