"""The port's examples run end to end on the CPU at their smallest size:
the Lotka-Volterra closed loop (``examples/lotka_volterra.py``, the
prey-cap assert included) and the quadrotor fleet with its closed-loop
evaluation (``examples/fleet.py``); ``--mesh`` is refused."""

import pytest

from pyneuralempc_tpu_torch.examples import fleet, lotka_volterra

import _torch_threads  # noqa: F401  (one torch thread)


def test_lotka_volterra_main(capsys):
    lotka_volterra.main(["--cpu", "--steps", "4"])
    out = capsys.readouterr().out
    assert "solves converged: 2/2" in out and "(cap 60)" in out


def test_fleet_main_closed_loop(capsys):
    fleet.main(["--cpu", "--batch", "4", "--H", "10", "--steps", "1",
                "--closed-loop", "2"])
    out = capsys.readouterr().out
    assert "converged 4/4" in out
    assert "closed loop: 2 steps x 4 plants" in out
    assert "solves converged 12/12" in out


def test_fleet_mesh_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 #14"):
        fleet.main(["--cpu", "--mesh", "2"])
