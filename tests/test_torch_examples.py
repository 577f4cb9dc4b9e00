"""The port's examples run end to end on the CPU at their smallest size:
the Lotka-Volterra closed loop (``examples/lotka_volterra.py``, the
prey-cap assert included) and the quadrotor fleet with its closed-loop
evaluation (``examples/fleet.py``), also sharded (``--mesh``)."""

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


def test_fleet_mesh_raises(capsys):
    """``--mesh 2`` (once refused) shards the fleet over two shards of
    the CPU."""
    fleet.main(["--cpu", "--mesh", "2", "--batch", "4", "--H", "10",
                "--steps", "1"])
    out = capsys.readouterr().out
    assert "scenario-sharded over 2 devices (2 problems/device)" in out
    assert "converged 4/4" in out and "warm fleet step" in out
