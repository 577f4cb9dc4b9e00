"""The port stands alone: it imports no JAX and nothing of the JAX package,
and neither does chip_smoke.py."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "pyneuralempc_tpu")


def _imports(path):
    """Top-level module names a file imports (absolute imports only)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_fresh_import_pulls_in_no_jax():
    code = ("import sys, pyneuralempc_tpu_torch, "
            "pyneuralempc_tpu_torch.solve.riccati; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_import_anywhere_in_the_port():
    files = sorted((ROOT / "pyneuralempc_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, (f, name)


def test_entry_points_default_to_the_card():
    """Every exported function or method that takes a ``device`` runs on
    the card unless the caller asks for the CPU."""
    import inspect

    import pyneuralempc_tpu_torch as T
    checked = {}
    for name in T.__all__:
        obj = getattr(T, name)
        if inspect.isclass(obj):
            fns = {f"{name}.{k}": v for k, v in vars(obj).items()
                   if inspect.isfunction(v) or isinstance(v, staticmethod)}
        elif callable(obj):
            fns = {name: obj}
        else:
            continue
        for qual, fn in fns.items():
            fn = getattr(fn, "__func__", fn)
            param = inspect.signature(fn).parameters.get("device")
            if param is not None and param.default is not param.empty:
                checked[qual] = param.default
    assert {"NMPC.__init__", "sample_transitions", "mlp_init",
            "MLPDynamics.init_params", "DynamicsModel.init_params",
            "mlp_params_from_numpy", "transcribe",
            "Box.tile"} <= set(checked)
    assert all(d == "cuda" for d in checked.values()), checked


def test_chip_smoke_refuses_without_a_card():
    """No CUDA device: chip_smoke.py exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
