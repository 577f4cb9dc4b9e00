"""The port stands alone: it imports no JAX and nothing of the JAX package,
and neither do chip_smoke.py and chip_backward_designs.py."""

import ast
import subprocess
import sys
from pathlib import Path

import _torch_threads  # noqa: F401  (one torch thread)

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
            "pyneuralempc_tpu_torch.solve.riccati, "
            "pyneuralempc_tpu_torch.api.simulate, "
            "pyneuralempc_tpu_torch.examples.lotka_volterra, "
            "pyneuralempc_tpu_torch.examples.fleet, "
            "pyneuralempc_tpu_torch.examples.cartpole, "
            "pyneuralempc_tpu_torch.examples.fleet_rnn, "
            "pyneuralempc_tpu_torch.examples.quadrotor, "
            "pyneuralempc_tpu_torch.models.rnn, "
            "pyneuralempc_tpu_torch.models.rolling, "
            "pyneuralempc_tpu_torch.models.importers, "
            "pyneuralempc_tpu_torch.examples.fleet_wide, "
            "pyneuralempc_tpu_torch.solve.alm, "
            "pyneuralempc_tpu_torch.solve.diff, "
            "pyneuralempc_tpu_torch.utils.native, "
            "pyneuralempc_tpu_torch.utils.profiling, "
            "pyneuralempc_tpu_torch.utils.timing, "
            "pyneuralempc_tpu_torch.ops.scan, "
            "pyneuralempc_tpu_torch.solve.pscan, "
            "pyneuralempc_tpu_torch.parallel, "
            "pyneuralempc_tpu_torch.parallel.horizon, "
            "pyneuralempc_tpu_torch.parallel.sharding; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_import_anywhere_in_the_port():
    files = sorted((ROOT / "pyneuralempc_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_backward_designs.py"]
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
    # load_torch_mlp keeps a given tensor's device unless asked for
    # another (numpy arrays go to the card)
    assert checked.pop("load_torch_mlp") is None
    assert {"NMPC.__init__", "sample_transitions", "mlp_init",
            "MLPDynamics.init_params", "DynamicsModel.init_params",
            "mlp_params_from_numpy", "params_from_numpy", "transcribe",
            "Box.tile", "fit_normalized_surrogate", "GRUDynamics.init_params",
            "LSTMDynamics.init_params", "load_keras_h5",
            "load_keras_lstm_h5", "load_keras_gru_h5",
            "load_keras_h5_rolling", "check_model"} <= set(checked)
    assert all(d == "cuda" for d in checked.values()), checked
    # the new examples' builders and the models' initialisers too
    from pyneuralempc_tpu_torch.examples import (cartpole, fleet_rnn,
                                                 fleet_wide, quadrotor)
    from pyneuralempc_tpu_torch.models import rnn
    for fn in (cartpole.make_cartpole_mpc, cartpole.fit_cartpole_mlp,
               cartpole.swing_up, fleet_rnn.fit_fleet_gru,
               fleet_rnn.make_fleet_rnn_mpc, fleet_rnn.fleet_starts,
               quadrotor.fit_quad_mlp, quadrotor.make_quadrotor_mpc,
               fleet_wide.make_fleet_wide_mpc,
               rnn.gru_init, rnn.lstm_init):
        assert inspect.signature(fn).parameters["device"].default == \
            "cuda", fn


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


def test_every_port_test_file_sets_one_torch_thread():
    """Each tests/test_torch_*.py imports tests/_torch_threads.py, which
    sets one torch intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) > 10
    for f in files:
        assert "_torch_threads" in _imports(f), f
    import torch
    assert torch.get_num_threads() == 1


def test_gru_reference_imports_neither_the_port_nor_jax():
    """tests/_torch_gru_reference.py, the plain reference of the lifted
    GRU, is plain torch: it imports no JAX, nothing of the JAX package and
    nothing of the port, and run alone it loads none of them."""
    path = ROOT / "tests" / "_torch_gru_reference.py"
    names = {n.split(".")[0] for n in _imports(path)}
    assert names == {"torch"}
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import _torch_gru_reference; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('pyneuralempc_tpu_torch',)!r}]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
