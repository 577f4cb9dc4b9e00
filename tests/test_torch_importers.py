"""The model importers (ROADMAP Queue 1 #13): the port's
``models/importers.py`` against the JAX package's on the same files.

Every fixture is written by hand with h5py (``tests/_torch_h5.py``): a
Sequential Dense stack, a functional chain, a branching graph (Add,
Concatenate), a graph with Rescaling, Normalization, BatchNormalization
and LayerNormalization (``scale=False`` among them), a multi-input graph
with a shared layer, LSTM, stacked LSTM and GRU nets (both GRU bias
layouts) and a rolling-window net; and a torch state_dict for
``load_torch_mlp``.  Each is loaded by both packages, and the imported
models agree on seeded inputs within 1e-5.  The width and invalid-branching
rejections raise the same errors, and one ``NMPC.next_batch`` with an
imported branching graph matches the JAX package's within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T

import _torch_h5 as W
import _torch_threads  # noqa: F401  (one torch thread)

h5py = pytest.importorskip("h5py")

TOL = 1e-5


def _xu(n, x_dim, u_dim, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (n, x_dim)).astype(np.float32),
            rng.uniform(-scale, scale, (n, u_dim)).astype(np.float32))


def _same_forward(jmodel, jparams, tmodel, tparams, x, u):
    got = tmodel(torch.as_tensor(x), torch.as_tensor(u), params=tparams)
    ref = jmodel(jnp.asarray(x), jnp.asarray(u), params=jparams)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def _both(loader, path, **kw):
    jm, jp = getattr(J, loader)(path, **kw)
    tm, tp = getattr(T, loader)(path, device="cpu", **kw)
    return jm, jp, tm, tp


@pytest.mark.parametrize("case", ["sequential", "functional", "branching",
                                  "norms", "multi_input_shared"])
def test_keras_h5_matches_jax(tmp_path, case):
    path = str(tmp_path / f"{case}.h5")
    x_dim, u_dim = 2, 1
    if case == "sequential":
        W.write_sequential(path, (3, 16, 16, 2), ("relu", "gelu", "linear"))
    elif case == "functional":
        W.write_functional_chain(path, (3, 8, 2), ("tanh", "linear"))
    elif case == "branching":
        W.write_branching(path)
    elif case == "norms":
        W.write_norms(path)
    else:
        W.write_multi_input_shared(path)
    jm, jp, tm, tp = _both("load_keras_h5", path, x_dim=x_dim, u_dim=u_dim)
    assert tm.activation == jm.activation
    assert tm.hidden == jm.hidden and tm.dims == T.Dims(x_dim, u_dim)
    for seed in range(3):
        _same_forward(jm, jp, tm, tp, *_xu(32, x_dim, u_dim, seed,
                                           scale=2.0))


def test_keras_rolling_matches_jax(tmp_path):
    path = str(tmp_path / "rolling.h5")
    window, x_dim, u_dim = 3, 2, 1
    W.write_sequential(path, (window * x_dim + u_dim, 12, x_dim),
                       ("tanh", "linear"), seed=3)
    jr, jp = J.load_keras_h5_rolling(path, x_dim=x_dim, u_dim=u_dim,
                                     window=window)
    tr, tp = T.load_keras_h5_rolling(path, x_dim=x_dim, u_dim=u_dim,
                                     window=window, device="cpu")
    assert tr.window == jr.window == window
    z, u = _xu(16, window * x_dim, u_dim, seed=4)
    _same_forward(jr.model, jp, tr.model, tp, z, u)


@pytest.mark.parametrize("units", [(6,), (5, 4)], ids=["lstm", "stacked"])
def test_keras_lstm_matches_jax(tmp_path, units):
    path = str(tmp_path / "lstm.h5")
    x_dim, u_dim = 2, 1
    W.write_lstm(path, x_dim + u_dim, units, x_dim)
    for mode in ("delta", "direct"):
        jl, jp = J.load_keras_lstm_h5(path, x_dim=x_dim, u_dim=u_dim,
                                      mode=mode)
        tl, tp = T.load_keras_lstm_h5(path, x_dim=x_dim, u_dim=u_dim,
                                      mode=mode, device="cpu")
        assert type(tl).__name__ == type(jl).__name__
        nz = jl.model.dims.x
        assert tl.model.dims.x == nz
        z, u = _xu(16, nz, u_dim, seed=5)
        _same_forward(jl.model, jp, tl.model, tp, z, u)


@pytest.mark.parametrize("reset_after", [True, False])
def test_keras_gru_matches_jax(tmp_path, reset_after):
    path = str(tmp_path / "gru.h5")
    x_dim, u_dim, units = 2, 1, 5
    W.write_gru(path, x_dim + u_dim, units, x_dim, reset_after=reset_after)
    jg, jp = J.load_keras_gru_h5(path, x_dim=x_dim, u_dim=u_dim)
    tg, tp = T.load_keras_gru_h5(path, x_dim=x_dim, u_dim=u_dim,
                                 device="cpu")
    assert tg.hidden == jg.hidden == units
    z, u = _xu(16, x_dim + units, u_dim, seed=6)
    _same_forward(jg.model, jp, tg.model, tp, z, u)


def test_load_torch_mlp_matches_jax_and_torch():
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(3, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 2))
    sd = net.state_dict()
    jm, jp = J.load_torch_mlp(sd, x_dim=2, u_dim=1)
    tm, tp = T.load_torch_mlp(sd, x_dim=2, u_dim=1)
    assert tm.hidden == jm.hidden == (16, 16)
    # the tensors keep their device (here the CPU's) when none is named
    assert all(t.device.type == "cpu" for layer in tp for t in layer.values())
    x, u = _xu(32, 2, 1, seed=7)
    _same_forward(jm, jp, tm, tp, x, u)
    with torch.no_grad():
        ref = net(torch.cat([torch.as_tensor(x), torch.as_tensor(u)], 1))
    got = tm(torch.as_tensor(x), torch.as_tensor(u), params=tp)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)
    # a bias-free layer gets zeros; numpy weights load too
    nb = {"0.weight": sd["0.weight"].numpy(), "2.weight": sd["2.weight"],
          "2.bias": sd["2.bias"], "4.weight": sd["4.weight"],
          "4.bias": sd["4.bias"]}
    jm2, jp2 = J.load_torch_mlp(nb, x_dim=2, u_dim=1)
    tm2, tp2 = T.load_torch_mlp(nb, x_dim=2, u_dim=1, device="cpu")
    assert not tp2[0]["b"].any()
    _same_forward(jm2, jp2, tm2, tp2, x, u)


def _same_error(fn_j, fn_t):
    with pytest.raises(ValueError) as ej:
        fn_j()
    with pytest.raises(ValueError) as et:
        fn_t()
    assert str(et.value) == str(ej.value)
    return str(et.value)


def test_rejections_match_jax(tmp_path):
    seq = str(tmp_path / "seq.h5")
    W.write_sequential(seq, (3, 8, 2), ("tanh", "linear"))
    msg = _same_error(lambda: J.load_keras_h5(seq, x_dim=3, u_dim=1),
                      lambda: T.load_keras_h5(seq, x_dim=3, u_dim=1,
                                              device="cpu"))
    assert "input dim" in msg
    _same_error(lambda: J.load_keras_h5(seq, x_dim=2, u_dim=1, out_dim=3),
                lambda: T.load_keras_h5(seq, x_dim=2, u_dim=1, out_dim=3,
                                        device="cpu"))
    branch = str(tmp_path / "branch.h5")
    W.write_functional_chain(branch, (3, 8, 2), ("tanh", "linear"),
                             branch=True)
    msg = _same_error(lambda: J.load_keras_h5(branch, x_dim=2, u_dim=1),
                      lambda: T.load_keras_h5(branch, x_dim=2, u_dim=1,
                                              device="cpu"))
    assert "exactly one input" in msg
    graph = str(tmp_path / "graph.h5")
    W.write_branching(graph)
    _same_error(lambda: J.load_keras_h5(graph, x_dim=2, u_dim=1, out_dim=3),
                lambda: T.load_keras_h5(graph, x_dim=2, u_dim=1, out_dim=3,
                                        device="cpu"))
    multi = str(tmp_path / "multi.h5")
    W.write_multi_input_shared(multi, x_width=3)
    _same_error(lambda: J.load_keras_h5(multi, x_dim=2, u_dim=1),
                lambda: T.load_keras_h5(multi, x_dim=2, u_dim=1,
                                        device="cpu"))
    lstm = str(tmp_path / "lstm.h5")
    W.write_lstm(lstm, 4, (6,), 2)
    _same_error(lambda: J.load_keras_lstm_h5(lstm, x_dim=2, u_dim=1),
                lambda: T.load_keras_lstm_h5(lstm, x_dim=2, u_dim=1,
                                             device="cpu"))
    gru = str(tmp_path / "gru.h5")
    W.write_gru(gru, 3, 5, 3)
    _same_error(lambda: J.load_keras_gru_h5(gru, x_dim=2, u_dim=1),
                lambda: T.load_keras_gru_h5(gru, x_dim=2, u_dim=1,
                                            device="cpu"))
    _same_error(lambda: J.load_keras_lstm_h5(gru, x_dim=2, u_dim=1),
                lambda: T.load_keras_lstm_h5(gru, x_dim=2, u_dim=1,
                                             device="cpu"))


def test_imported_graph_in_nmpc_matches_jax(tmp_path):
    path = str(tmp_path / "skipnet.h5")
    W.write_branching(path)
    jm, jp, tm, tp = _both("load_keras_h5", path, x_dim=2, u_dim=1)
    kw = dict(H=5, DT=0.1, integrator="delta")
    box = dict(states_constraint=[[-3.0, 3.0]] * 2,
               control_constraint=[[-1.0, 1.0]])
    jmpc = J.NMPC(jm, lambda x, u: jnp.sum(u ** 2) + jnp.sum(x ** 2),
                  [J.DomainConstraint(**box)], **kw)
    tmpc = T.NMPC(tm, lambda x, u: torch.sum(u ** 2) + torch.sum(x ** 2),
                  [T.DomainConstraint(**box)], device="cpu", **kw)
    xs = np.array([[0.2, -0.1], [-0.4, 0.3], [0.5, 0.5]], np.float32)
    _, jres = jmpc.next_batch(jnp.asarray(xs), params=jp)
    _, tres = tmpc.next_batch(torch.as_tensor(xs), params=tp)
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    assert bool(tres.converged.all())
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    assert np.abs(tres.u.numpy() - np.asarray(jres.u)).max() <= 1e-4
