"""The port's spans (``utils/tracing.py``) on the CPU.

* Off: outside a profiler ``span()`` is the one shared no-op, a warm
  ``next_batch`` records nothing and never enters ``record_function``.
* On: under ``torch.profiler``, one warm ``next_batch`` gives one root
  ``nmpc.replan``; ``ip.iteration`` spans equal the lockstep iterations;
  every span lies inside its parent and shares its request; the profiler's
  events carry the names; a ``batch_chunk`` slice is a child, not a root.
* ``kkt.prepare`` notes the tanh layers' tangent-kernel launches, and
  holds one ``kkt.dynamics`` (the model's blocks) and one ``kkt.cost``
  (the cost's Hessians) child each time it runs.
* The profiler on or off gives the same plans bit for bit.
* Dense backend: ``kkt.sweep`` spans equal the δ levels factored.
* The buffer keeps the newest spans and counts those it dropped.
* The benchmark's nine span readers, fed a synthetic span list, give the
  values their docstrings define; the two of the blocks' parts read
  nothing where the program records no such spans.
"""

import sys
import types
from collections import Counter
from pathlib import Path

import pytest
import torch

import _torch_threads  # noqa: F401  (one torch thread)
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu_torch.solve import interior_point as ip
from pyneuralempc_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
BOX = dict(states_constraint=[[-1.0, 1.0], [-1.0, 0.35]],
           control_constraint=[[0.0, 1.2]])
X0S = torch.tensor([[0.5, -0.5], [0.3, -0.6], [0.7, -0.4], [0.4, -0.8]])
CPU = [torch.profiler.ProfilerActivity.CPU]


def _fleet(kkt="auto"):
    """A small MLP fleet (B=4, H=5) after its cold solve: the controller,
    its weights and the warm carry."""
    model = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8, 8])
    params = model.init_params(torch.Generator().manual_seed(0),
                               device="cpu")
    mpc = T.NMPC(model, lambda x, u: 1.1 * torch.sum(u)
                 + 1e-4 * torch.sum(u * u),
                 [T.DomainConstraint(**BOX)], H=5, DT=0.1, integrator="rk4",
                 config=T.IPConfig(tol=1e-5, polish_iters=2, kkt=kkt),
                 device="cpu")
    carry, _ = mpc.next_batch(X0S, params=params)
    return mpc, params, carry


def _new_spans(fn):
    """``fn()``'s result and the spans that finished during it."""
    n0 = len(tracing.finished())
    out = fn()
    return out, tracing.finished()[n0:]


@pytest.fixture(scope="module")
def fleet():
    return _fleet()


def test_off_records_nothing_and_enters_no_record_function(fleet,
                                                            monkeypatch):
    mpc, params, carry = fleet
    assert tracing.span("a") is tracing.span("b", device="cpu", B=3)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, spans = _new_spans(lambda: mpc.next_batch(X0S, params=params,
                                                 carry=carry))
    assert spans == []


def test_on_one_root_with_nested_spans(fleet):
    mpc, params, carry = fleet
    with torch.profiler.profile(activities=CPU) as prof:
        (_, res), spans = _new_spans(lambda: mpc.next_batch(
            X0S, params=params, carry=carry))
    roots = [s for s in spans if s.parent is None]
    assert [r.name for r in roots] == ["nmpc.replan"]
    assert roots[0].attrs == {"B": 4}
    n = Counter(s.name for s in spans)
    assert n["ip.iteration"] == int(res.iterations.max()) > 0
    assert n["ip.solve"] == n["ip.polish"] == n["ip.init"] == 1
    # one exit test an iteration, one more that ends the loop
    assert n["sync.live"] == n["ip.iteration"] + 1
    assert n["ip.line_search"] == n["ip.residuals"] == n["ip.iteration"]
    assert n["sync.ls"] >= n["ip.iteration"]
    assert n["kkt.sweep"] >= n["kkt.solve"] >= n["ip.iteration"]
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.request == roots[0].request
        assert s.t0_ns <= s.t1_ns and s.device_ms == s.host_ms
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.t0_ns <= s.t0_ns and s.t1_ns <= up.t1_ns, (s.name,
                                                                 up.name)
            inner = sum(c.host_ms for c in spans if c.parent == up.id)
            assert inner <= up.host_ms
    assert {"nmpc.replan", "ip.solve", "ip.iteration", "kkt.prepare",
            "kkt.solve", "kkt.sweep", "ip.line_search", "ip.residuals",
            "sync.ls", "sync.live"} <= {e.name for e in prof.events()}


def test_prepare_notes_the_tanh_kernel_launches(fleet, monkeypatch):
    """Each ``kkt.prepare`` notes the tanh layers' tangent-kernel launches
    its stage blocks made: one K1 and one K2 a tanh layer a model
    evaluation (RK4's four, two layers; the layers taken as TanhLayers
    at this small fleet's size too).  On the CPU the plain versions run
    in the kernels' place; here each counts as its kernel's launch."""
    from pyneuralempc_tpu_torch.models import mlp
    from pyneuralempc_tpu_torch.ops.cuda import tanh_dense as td
    mpc, params, carry = fleet
    monkeypatch.setattr(mlp, "FUSED_MIN_ELEMENTS", 0)

    def counted(name, counter):
        real = getattr(td, name)

        def plain(*args):
            setattr(td, counter, getattr(td, counter) + 1)
            return real(*args)
        monkeypatch.setattr(td, name, plain)
    counted("tangent_fwd_plain", "K1_LAUNCHES")
    counted("tangent_vjp_plain", "K2_LAUNCHES")
    with torch.profiler.profile(activities=CPU):
        _, spans = _new_spans(lambda: mpc.next_batch(
            X0S, params=params, carry=carry))
    prep = [s.attrs for s in spans if s.name == "kkt.prepare"]
    assert prep and all(a == {"k1_launches": 8, "k2_launches": 8}
                        for a in prep)


def test_prepare_holds_one_dynamics_and_one_cost_span(fleet):
    """Each ``kkt.prepare`` has exactly one ``kkt.dynamics`` child (the
    model's A, B and G) and one ``kkt.cost`` child (the cost's Hessians),
    each inside it and of its request, and no other span holds them."""
    mpc, params, carry = fleet
    with torch.profiler.profile(activities=CPU):
        _, spans = _new_spans(lambda: mpc.next_batch(
            X0S, params=params, carry=carry))
    by_id = {s.id: s for s in spans}
    prep = [s for s in spans if s.name == "kkt.prepare"]
    assert prep
    for name in ("kkt.dynamics", "kkt.cost"):
        parts = [s for s in spans if s.name == name]
        assert len(parts) == len(prep)
        assert sorted(by_id[s.parent].id for s in parts) == sorted(
            p.id for p in prep)
        for s in parts:
            up = by_id[s.parent]
            assert up.name == "kkt.prepare" and s.request == up.request
            assert up.t0_ns <= s.t0_ns <= s.t1_ns <= up.t1_ns
    assert tracing.span("kkt.dynamics") is tracing.span("kkt.cost")


def test_a_batch_chunk_is_a_child_of_the_call(fleet):
    mpc, params, carry = fleet
    with torch.profiler.profile(activities=CPU):
        _, spans = _new_spans(lambda: mpc.next_batch(
            X0S, params=params, carry=carry, batch_chunk=2))
    replans = [s for s in spans if s.name == "nmpc.replan"]
    root = [s for s in replans if s.parent is None]
    assert len(replans) == 3 and len(root) == 1
    assert all(s.parent == root[0].id for s in replans if s is not root[0])
    assert {s.attrs["B"] for s in replans} == {4, 2}


def test_profiler_on_and_off_give_the_same_plans(fleet):
    mpc, params, carry = fleet
    _, off = mpc.next_batch(X0S, params=params, carry=carry)
    with torch.profiler.profile(activities=CPU):
        _, on = mpc.next_batch(X0S, params=params, carry=carry)
    assert torch.equal(on.x, off.x) and torch.equal(on.u, off.u)
    assert torch.equal(on.iterations, off.iterations)


def test_dense_sweeps_equal_the_delta_levels_factored(monkeypatch):
    mpc, params, carry = _fleet(kkt="dense")
    assert mpc.kkt_backend == "dense"
    factored = []
    lu = ip.lu_solve_equilibrated

    def counted(K, rhs):
        factored.append(K.shape[0])
        return lu(K, rhs)
    monkeypatch.setattr(ip, "lu_solve_equilibrated", counted)
    with torch.profiler.profile(activities=CPU):
        _, spans = _new_spans(lambda: mpc.next_batch(
            X0S, params=params, carry=carry))
    n = Counter(s.name for s in spans)
    assert n["kkt.sweep"] == len(factored) > 0
    # an indefinite member climbs the ladder; the others keep their step
    W = torch.eye(3).repeat(3, 1, 1)
    W[1] = -torch.eye(3)
    factored.clear()
    with torch.profiler.profile(activities=CPU):
        (_, _, ok), spans = _new_spans(lambda: ip.kkt_step(
            W, torch.zeros(3, 3), torch.ones(3, 1, 3), torch.ones(3, 3),
            torch.zeros(3, 1)))
    n = Counter(s.name for s in spans)
    assert bool(ok.all()) and len(factored) > 1
    assert factored[1:] == [1] * (len(factored) - 1)
    assert n["kkt.sweep"] == len(factored)
    assert n["sync.ladder"] == len(factored)


def test_the_buffer_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    monkeypatch.setattr(tracing, "_finished",
                        tracing.collections.deque(maxlen=3))
    dropped = tracing.dropped()
    with torch.profiler.profile(activities=CPU):
        for name in "abcde":
            with tracing.span(name):
                pass
    assert [s.name for s in tracing.finished()] == ["c", "d", "e"]
    assert tracing.dropped() == dropped + 2


def _span(i, name, parent, request, t0, t1, dev):
    return types.SimpleNamespace(id=i, name=name, parent=parent,
                                 request=request, t0_ns=t0, t1_ns=t1,
                                 device_ms=dev, host_ms=(t1 - t0) * 1e-6,
                                 attrs={})


def _synthetic():
    """Three re-plans, one traced a window (device alone, then with host
    ops), after an earlier run's: each traced re-plan's spans with device
    ms and host intervals (ns) set by hand."""
    spans, k = [], [0]

    def add(name, parent, request, t0, t1, dev):
        k[0] += 1
        spans.append(_span(k[0], name, parent, request, t0, t1, dev))
        return k[0]

    for req, scale in ((1, 100.0), (2, 1.0), (3, 1000.0)):
        root = add("nmpc.replan", None, req, 0, 10_000_000, 90.0 * scale)
        solve = add("ip.solve", root, req, 0, 9_000_000, 80.0 * scale)
        add("ip.init", solve, req, 0, 1_000_000, 3.0 * scale)
        for _ in range(2):
            it = add("ip.iteration", solve, req, 0, 4_000_000, 35.0 * scale)
            prep = add("kkt.prepare", it, req, 0, 1_000_000, 20.0 * scale)
            add("kkt.dynamics", prep, req, 0, 600_000, 12.0 * scale)
            add("kkt.cost", prep, req, 0, 300_000, 5.0 * scale)
            ks = add("kkt.solve", it, req, 0, 1_000_000, 4.0 * scale)
            add("kkt.sweep", ks, req, 0, 500_000, 1.5 * scale)
            add("sync.ladder", ks, req, 0, 100_000, 0.1 * scale)
            add("kkt.sweep", ks, req, 0, 500_000, 1.5 * scale)
            ls = add("ip.line_search", it, req, 0, 1_000_000, 6.0 * scale)
            soc = add("kkt.solve", ls, req, 0, 200_000, 1.0 * scale)
            add("kkt.sweep", soc, req, 0, 100_000, 0.8 * scale)
            for _ in range(3):
                add("sync.ls", ls, req, 0, 200_000, 0.01 * scale)
            add("ip.residuals", it, req, 0, 500_000, 2.5 * scale)
            add("sync.live", solve, req, 0, 300_000, 0.01 * scale)
    return spans


READ = {
    # request 2 (the device-alone window's re-plan), by hand
    "kkt_blocks_ms": 2 * 20.0,
    "kkt_dynamics_ms": 2 * 12.0,
    "kkt_cost_ms": 2 * 5.0,
    "kkt_solve_ms": 2 * (4.0 + 1.0),
    "line_search_ms": 2 * (6.0 - 1.0),
    "residuals_ms": 3.0 + 2 * 2.5,
    # 2 × (0.1 + 3 × 0.2 + 0.3) ms of sync spans over 10 ms of root
    "host_sync_wait_pct": 100.0 * 2 * 1.0 / 10.0,
    "ls_passes_per_iter": 3.0,
    "kkt_sweeps_per_iter": 3.0,
}


@pytest.mark.parametrize("metric", sorted(READ))
def test_span_readers_on_synthetic_spans(metric, monkeypatch):
    if str(ROOT) not in sys.path:
        monkeypatch.syspath_prepend(str(ROOT))
    from benchmark.harness.layout import Layout
    reader = Layout(ROOT).reader(metric)
    monkeypatch.setattr(tracing, "finished", _synthetic)
    got = reader.read(types.SimpleNamespace(traced=1))
    assert got == pytest.approx(READ[metric], rel=1e-12)
    # a program that recorded fewer roots than the windows hold: nothing
    assert reader.read(types.SimpleNamespace(traced=2)) is None
    monkeypatch.setattr(tracing, "finished", lambda: [])
    assert reader.read(types.SimpleNamespace(traced=1)) is None


@pytest.mark.parametrize("metric", ["kkt_dynamics_ms", "kkt_cost_ms"])
def test_block_part_readers_read_nothing_without_their_spans(metric,
                                                             monkeypatch):
    """A program without the spans ``kkt.dynamics`` and ``kkt.cost`` (as
    before they were added): their readers return None and raise
    nothing."""
    if str(ROOT) not in sys.path:
        monkeypatch.syspath_prepend(str(ROOT))
    from benchmark.harness.layout import Layout
    reader = Layout(ROOT).reader(metric)
    monkeypatch.setattr(tracing, "finished", lambda: [
        s for s in _synthetic() if s.name not in ("kkt.dynamics",
                                                  "kkt.cost")])
    assert reader.read(types.SimpleNamespace(traced=1)) is None
