"""The span readers in a traced run: each cell at its tiny size on the CPU,
one ``--trace 1`` run through ``driver.run``, and every per-layer metric read
from the port's spans present and finite."""

import math
import time

import pytest

from benchmark.harness import driver
from benchmark.harness.layout import Layout

from conftest import CELLS, ROOT, TINY

SPAN_METRICS = ("kkt_blocks_ms", "kkt_solve_ms", "line_search_ms",
                "residuals_ms", "host_sync_wait_pct", "ls_passes_per_iter",
                "kkt_sweeps_per_iter")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_metrics(cell):
    res = driver.run(Layout(ROOT), cell, 2 ** 31 + 11, 0.3, True,
                     t_start=time.perf_counter(), device="cpu",
                     overrides=TINY[cell])
    assert res["correct"], res["checks"]
    got = {m: res["metrics"].get(m, {}).get("value") for m in SPAN_METRICS}
    assert all(v is not None and math.isfinite(v) for v in got.values()), got
    assert got["ls_passes_per_iter"] >= 1 and got["kkt_sweeps_per_iter"] >= 1
    assert 0 < got["host_sync_wait_pct"] < 100
