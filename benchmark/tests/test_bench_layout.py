"""The harness is driven by data: a configuration, a traffic mix, a metric
reader and a kernel family, each dropped in as new files beside a copy of
the benchmark with entries in its ``BENCHMARK.json``, are found and run by
name, and no file of the benchmark is edited."""

import hashlib
import json
import shutil
import textwrap
import time

from benchmark.harness import driver
from benchmark.harness.layout import Layout

from conftest import ROOT

CONFIG = textwrap.dedent('''
    """A dummy configuration: a damped two-state ODE held at a target."""
    import torch
    from benchmark.harness.cell import Cell
    from benchmark.reference import nlp


    def f(x, u):
        return torch.cat([x[:, 1:2], -x[:, 0:1] - 0.5 * x[:, 1:2] + u],
                         dim=1)


    def euler(x, u, dt):
        return x + dt * f(x, u)


    def build(cfg, mix, *, device, cache_dir, control=False):
        from pyneuralempc_tpu_torch import (NMPC, DomainConstraint,
                                            IPConfig, StageCost,
                                            torch_dynamics)
        H, DT = cfg["H"], cfg["DT"]
        cost = StageCost(stage=lambda x, u: torch.sum((x - 0.5) ** 2)
                         + 0.1 * torch.sum(u ** 2))
        box = DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                               control_constraint=[[-1.0, 1.0]])
        mpc = NMPC(torch_dynamics(f, 2, 1), cost, [box], H=H, DT=DT,
                   integrator="euler", config=IPConfig(), device=device)
        kw = dict(dtype=torch.float64, device=device)
        return Cell(
            mpc=mpc, params=None,
            problem=nlp.Problem(
                H=H, nx=2, nu=1, phi=lambda x, u: euler(x, u, DT),
                cost=lambda X, U, tvp, p: (((X - 0.5) ** 2).sum((1, 2))
                                           + 0.1 * (U ** 2).sum((1, 2))),
                lb=torch.tensor([-2.0, -2.0] * H + [-1.0] * H, **kw),
                ub=torch.tensor([2.0, 2.0] * H + [1.0] * H, **kw)),
            plant=lambda x, u: euler(x, u, DT), lift=lambda x: x,
            stage_flops=8)
''')
METRIC = textwrap.dedent('''
    """How many kernel families name this metric (the dummy's one)."""


    def read(ctx):
        return sum("dummy_families" in f.METRICS for f in ctx.families)
''')
E2E = textwrap.dedent('''
    """The window's re-plans."""


    def read(ctx):
        return len(ctx.records)
''')
FAMILY = textwrap.dedent('''
    """A dummy kernel family."""
    METRICS = ("dummy_families",)
    PATTERNS = (r"dummy_kernel",)
    SWEEP_COUNTERS = ()
''')


def _digest(root):
    h = hashlib.sha256()
    files = [root / "BENCHMARK.json"] + sorted(
        p for p in (root / "benchmark").rglob("*") if p.is_file()
        and "_cache" not in p.parts and "__pycache__" not in p.parts)
    for p in files:
        h.update(str(p.relative_to(root)).encode() + p.read_bytes())
    return h.hexdigest()


def test_new_files_run_by_name(tmp_path):
    before = _digest(ROOT)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = tmp_path / "benchmark"
    (bench / "configs" / "dummy_osc.py").write_text(CONFIG)
    (bench / "configs" / "dummy_osc.json").write_text(json.dumps({
        "name": "dummy_osc", "x_dim": 2, "u_dim": 1, "H": 5, "DT": 0.1,
        "layout": {"start_low": [-1.0, -1.0], "start_high": [1.0, 1.0],
                   "disturbed": [0, 1]},
        "check": {"limits": {"defect_max": 1e-3,
                             "stationarity_max": 1e-3}}}))
    (bench / "traffic" / "hold_b3.json").write_text(json.dumps({
        "batch": 3, "lead_in": 1, "check_per_replan": 3,
        "trace_replans": 1, "disturbance": {"std": 0.01}}))
    (bench / "metrics" / "dummy_families.py").write_text(METRIC)
    (bench / "metrics" / "dummy_replans.py").write_text(E2E)
    (bench / "kernels" / "dummy_family.py").write_text(FAMILY)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = "dummy_osc.hold_b3"
    spec["configs"].append({"name": "dummy_osc", "source": "a test",
                            "file": "benchmark/configs/dummy_osc.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": cell, "config": "dummy_osc",
                              "traffic": "hold_b3", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_replans", "unit": "replans",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": [cell]})
    spec["per_layer"].append({"name": "dummy_families", "unit": "families",
                              "better": "higher", "source": "device_trace",
                              "layer": "test", "moves": "dummy_replans",
                              "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    layout = Layout(tmp_path)
    for trace in (False, True):
        res = driver.run(layout, cell, 12345, 0.3, trace,
                         t_start=time.perf_counter(), device="cpu",
                         port_root=ROOT)
        assert res["correct"], res["checks"]
        names = set(res["metrics"])
        if trace:
            assert res["metrics"]["dummy_families"]["value"] == 1
            # the per-layer metrics that list only the real cells stay out
            assert names == {"dummy_families"}
        else:
            assert names == {"solves_per_s", "setup_s", "dummy_replans"}
            assert res["metrics"]["dummy_replans"]["value"] >= 1
    assert _digest(ROOT) == before
