"""The tanh layers' derivative rules (models/mlp.py ``TanhLayers``,
``TanhLayersVJP``; ops/cuda/tanh_dense.py's tangent passes, their plain
versions here on the CPU) against the same layers composed from ATen ops,
in float64, under the transforms the solver and its callers compose."""

import pytest
import torch
from torch.func import grad, hessian, jacfwd, jacrev, jvp, vjp, vmap

from pyneuralempc_tpu_torch.models import mlp
from pyneuralempc_tpu_torch.ops.cuda import tanh_dense as td

import _torch_threads  # noqa: F401  (one torch thread)

TOL = 1e-12
ACTS = ("tanh", "tanh", "linear")


@pytest.fixture(autouse=True)
def _any_size(monkeypatch):
    """mlp_apply takes TanhLayers at these tests' few rows too."""
    monkeypatch.setattr(mlp, "FUSED_MIN_ELEMENTS", 0)


def _params(sizes=(7, 16, 16, 5), seed=0):
    g = torch.Generator().manual_seed(seed)
    return [{"w": torch.randn(a, b, generator=g, dtype=torch.float64) / a
             ** 0.5,
             "b": 0.3 * torch.randn(b, generator=g, dtype=torch.float64)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _rand(*shape, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=torch.float64)


def _composite(params, h, acts=ACTS):
    """mlp_apply's layers as ATen ops, as before TanhLayers."""
    for layer, act in zip(params, acts):
        h = mlp._ACTIVATIONS[act](h @ layer["w"] + layer["b"])
    return h


def _fused(params, h):
    """The two tanh layers as one TanhLayers whatever the transforms, the
    output layer as ATen ops."""
    h = mlp.TanhLayers.apply(h, params[0]["w"], params[0]["b"],
                             params[1]["w"], params[1]["b"])[-1]
    return h @ params[2]["w"] + params[2]["b"]


def _port(params, h, acts=ACTS):
    """mlp_apply as the port runs it."""
    return mlp.mlp_apply(params, h, acts)


def _close(a, b):
    assert float((a - b).abs().max()) <= TOL * max(1.0, float(b.abs().max()))


def _rk4_step(apply, params):
    """One RK4 step of the MLP as dynamics: the stage blocks' function of
    one stage's (x, u), as ``phi1`` makes it (one row)."""
    def f(xu):
        x, u = xu[:5], xu[5:]

        def rhs(x):
            return apply(params, torch.cat([x, u])[None])[0]
        k1 = rhs(x)
        k2 = rhs(x + 0.05 * k1)
        k3 = rhs(x + 0.05 * k2)
        k4 = rhs(x + 0.1 * k3)
        return x + (0.1 / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
    return f


def _blocks(apply, params, xu, lam):
    """stage_blocks' per-stage jacfwd over vjp: (G, J) of each row."""
    f = _rk4_step(apply, params)

    def per_stage(z0, lam_row):
        def grad_and_val(z):
            v, back = vjp(f, z)
            return back(lam_row)[0], v
        return jacfwd(grad_and_val)(z0)
    return vmap(per_stage)(xu, lam)


@pytest.mark.parametrize("shape", [(4, 7), (3, 2, 7), (7,)])
def test_forward_matches_composite(shape):
    params, h = _params(), _rand(*shape)
    _close(_fused(params, h), _composite(params, h))
    _close(mlp.mlp_apply(params, h, ACTS), _composite(params, h))


def test_vjp_with_weight_and_bias_grads():
    params, h, c = _params(), _rand(6, 7), _rand(6, 5, seed=2)
    leaves = [h] + [t for layer in params for t in (layer["w"], layer["b"])]
    for t in leaves:
        t.requires_grad_(True)
    got = torch.autograd.grad((_fused(params, h) * c).sum(), leaves)
    want = torch.autograd.grad((_composite(params, h) * c).sum(), leaves)
    for a, b in zip(got, want):
        _close(a, b)


def test_jacfwd_over_vjp_under_one_vmap(monkeypatch):
    """The stage blocks' pattern: a vmap over stages of jacfwd over vjp;
    mlp_apply takes TanhLayers there, and every tangent pass runs on plain
    tensors, its two vmap levels folded into rows."""
    params, xu, lam = _params(), _rand(9, 7), _rand(9, 5, seed=2)
    calls = []

    def spy(real):
        def plain(*args):
            calls.append(all(a is None or not torch._C._functorch
                             .is_functorch_wrapped_tensor(a) for a in args))
            return real(*args)
        return plain
    for name in ("tangent_fwd_plain", "tangent_vjp_plain"):
        monkeypatch.setattr(td, name, spy(getattr(td, name)))
    fused = mlp.FUSED_LAYERS
    G, J = _blocks(_port, params, xu, lam)
    assert mlp.FUSED_LAYERS == fused + 8          # 4 evaluations x 2 layers
    assert calls == [True] * 16                   # 8 K1, 8 K2 (a layer each)
    Gc, Jc = _blocks(_composite, params, xu, lam)
    _close(G, Gc)
    _close(J, Jc)


@pytest.mark.parametrize("per_member_weights", [False, True])
def test_jacfwd_over_vjp_under_two_vmaps(per_member_weights):
    """over_members' pattern: a vmap over members of a vmap over stages;
    with per-member weights mlp_apply runs the layers as ATen ops."""
    B, H = 3, 4
    xu, lam = _rand(B, H, 7), _rand(B, H, 5, seed=2)
    if per_member_weights:
        stacked = [_params(seed=s) for s in range(B)]
        params = [{k: torch.stack([p[i][k] for p in stacked])
                   for k in ("w", "b")} for i in range(3)]
        in_dims = 0
    else:
        params, in_dims = _params(), None

    def member(apply):
        return vmap(lambda prm, x, l: _blocks(apply, prm, x, l),
                    in_dims=(in_dims, 0, 0))(params, xu, lam)
    fused = mlp.FUSED_LAYERS, mlp.ATEN_TANH_LAYERS
    G, J = member(_port)
    assert (mlp.FUSED_LAYERS - fused[0],
            mlp.ATEN_TANH_LAYERS - fused[1]) == ((0, 8) if per_member_weights
                                                 else (8, 0))
    Gc, Jc = member(_composite)
    _close(G, Gc)
    _close(J, Jc)


def test_hessian():
    params, z, lam = _params(), _rand(7), _rand(5, seed=2)

    def lagrangian(apply):
        return lambda zz: torch.dot(apply(params, zz[None])[0], lam)
    _close(hessian(lagrangian(_port))(z),
           hessian(lagrangian(_composite))(z))


@pytest.mark.parametrize("shape", [(7,), (3, 4, 7)])
def test_jacfwd_of_any_leading_shape(shape):
    """Rows of any leading shape fold into the tangent passes' rows."""
    params, h = _params(), _rand(*shape)
    _close(jacfwd(lambda x: _port(params, x))(h),
           jacfwd(lambda x: _composite(params, x))(h))


def test_reverse_over_reverse_wrt_weights():
    """The IFT path's shape: a vjp, with respect to the weights, of a
    gradient with respect to the input."""
    params, h, v = _params(), _rand(4, 7), _rand(4, 7, seed=3)
    c = _rand(4, 5, seed=2)

    def outer(apply):
        def of_weights(ws):
            prm = [dict(layer, w=w) for layer, w in zip(params, ws)]
            gh = grad(lambda hh: (apply(prm, hh) * c).sum())(h)
            return (gh * v).sum()
        return grad(of_weights)([layer["w"] for layer in params])
    for a, b in zip(outer(_fused), outer(_composite)):
        _close(a, b)


@pytest.mark.parametrize("layers", [1, 2])
def test_tangents_of_weights_and_bias(layers):
    """jacfwd with respect to every input of the layers, forward and
    through the vjp: weights with tangents take mlp_apply's ATen route,
    and TanhLayers' rules refuse weight tangents."""
    prm = _params()[:layers]
    wb = [t for layer in prm for t in (layer["w"], layer["b"])]
    h, g = _rand(3, 7), _rand(3, 16, seed=2)

    def outs(run):
        def f(hh, *wbs):
            y, back = vjp(lambda x: run(x, *wbs), hh)
            return y, back(g)[0]
        return jacfwd(f, argnums=tuple(range(1 + len(wb))))(h, *wb)

    def composite(x, *wbs):
        for W, b in zip(wbs[0::2], wbs[1::2]):
            x = torch.tanh(x @ W + b)
        return x

    def port(x, *wbs):
        return mlp.mlp_apply([{"w": W, "b": b} for W, b in
                              zip(wbs[0::2], wbs[1::2])], x,
                             ("tanh",) * layers)
    before = mlp.FUSED_LAYERS, mlp.ATEN_TANH_LAYERS
    got = outs(port)
    assert mlp.FUSED_LAYERS == before[0]
    assert mlp.ATEN_TANH_LAYERS > before[1]
    want = outs(composite)
    for a, b_ in zip(torch.utils._pytree.tree_leaves(got),
                     torch.utils._pytree.tree_leaves(want)):
        _close(a, b_)
    with pytest.raises(ValueError, match="no weight or bias tangents"):
        outs(lambda x, *wbs: mlp.TanhLayers.apply(x, *wbs)[-1])


def test_cotangents_of_inner_outputs():
    """TanhLayers returns every layer's output; where the inner ones get
    cotangents of their own the vjp splits into runs, under jacfwd over
    vjp and for the weights."""
    prm = _params()
    wb = [t for layer in prm[:2] for t in (layer["w"], layer["b"])]
    c1, c2 = _rand(16, seed=4), _rand(16, seed=5)

    def loss(run):
        def f(x, *wbs):
            y1, y2 = run(x, *wbs)
            return (y1 * c1).sum() + (y2 * c2).sum()
        return f

    def composite(x, *wbs):
        y1 = torch.tanh(x @ wbs[0] + wbs[1])
        return y1, torch.tanh(y1 @ wbs[2] + wbs[3])
    xs, dims = _rand(4, 7), (0,) + (None,) * len(wb)
    got = vmap(jacfwd(grad(loss(mlp.TanhLayers.apply))), in_dims=dims)(
        xs, *wb)
    want = vmap(jacfwd(grad(loss(composite))), in_dims=dims)(xs, *wb)
    _close(got, want)
    leaves = [t.clone().requires_grad_(True) for t in wb]
    x = _rand(4, 7).requires_grad_(True)
    got = torch.autograd.grad(loss(mlp.TanhLayers.apply)(x, *leaves),
                              [x, *leaves])
    want = torch.autograd.grad(loss(composite)(x, *leaves), [x, *leaves])
    for a, b_ in zip(got, want):
        _close(a, b_)


@pytest.mark.parametrize("outer", ["jacfwd", "jacrev"])
def test_transforms_over_the_tangent_passes(outer):
    """A transform outside jacfwd differentiates the tangent passes
    themselves: mlp_apply runs the layers as ATen ops under reverse over
    forward and under forward over forward."""
    params, z = _params(), _rand(7)
    t = {"jacfwd": jacfwd, "jacrev": jacrev}[outer]

    def second(apply):
        return t(jacfwd(lambda zz: apply(params, zz[None])[0]))(z)
    fused = mlp.FUSED_LAYERS
    got = second(_port)
    assert mlp.FUSED_LAYERS == fused
    _close(got, second(_composite))


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("dims", [(0, 0), (1, 0), (2, 1), (0, None)])
def test_tangent_fold(dims, rows, monkeypatch):
    """A tangent pass folds each vmap level into rows and equals the
    unbatched pass row by row; where each stage batches its one primal row
    (the stage blocks' layout) the rows it hands the kernel are a view of
    the tangents, at the strides jacfwd's basis left them."""
    S, T, K, N = 5, 3, 4, 6
    d_t, d_y = dims
    shape = [rows, K]                         # a stage's rows (lead, K)
    shape.insert(d_t, S)
    hd = _rand(T, *shape)                     # T outermost: jacfwd's basis
    y_shape = [rows, N]
    if d_y is not None:
        y_shape.insert(d_y, S)
    y, W = _rand(*y_shape, seed=2), _rand(K, N, seed=3)
    seen = []
    real = td.tangent_fwd_plain

    def spy(h, yy, w):
        seen.append(h)
        return real(h, yy, w)
    monkeypatch.setattr(td, "tangent_fwd_plain", spy)
    out = vmap(lambda hs, yy: vmap(
        lambda h: td.tangent_fwd(h, [yy], [W])[0])(hs),
        in_dims=(d_t + 1, d_y))(hd, y)
    assert len(seen) == 1
    if d_y is not None and rows == 1:
        assert seen[0].untyped_storage().data_ptr() == \
            hd.untyped_storage().data_ptr()
    hd_rows = hd.movedim(d_t + 1, 0)          # (S, T, rows, K)
    ys = y.movedim(d_y, 0) if d_y is not None else y.expand(S, rows, N)
    want = torch.stack([torch.stack([
        (hd_rows[s, t] @ W) * (1 - ys[s] ** 2) for t in range(T)])
        for s in range(S)])
    _close(out, want)


@pytest.mark.parametrize("least,fused", [(560, 2), (561, 0)])
def test_size_rule(least, fused, monkeypatch):
    """A run of tanh layers takes TanhLayers from FUSED_MIN_ELEMENTS
    tangent rows x width: here 5 stages x 7 tangents x 16 = 560."""
    monkeypatch.setattr(mlp, "FUSED_MIN_ELEMENTS", least)
    params, h = _params(), _rand(5, 1, 7)
    before = mlp.FUSED_LAYERS, mlp.ATEN_TANH_LAYERS
    got = vmap(jacfwd(lambda x: _port(params, x)))(h)
    assert (mlp.FUSED_LAYERS - before[0],
            mlp.ATEN_TANH_LAYERS - before[1]) == (fused, 2 - fused)
    _close(got, vmap(jacfwd(lambda x: _composite(params, x)))(h))


def test_layer_routes_and_counters():
    """FUSED_LAYERS counts the float32 tanh layers that ran as TanhLayers
    (a forward-mode transform active); ATEN_TANH_LAYERS those that ran as
    ATen ops (no forward-mode transform); PLAIN_LAYERS every other layer:
    relu, the linear output layer, the bf16 path."""
    params32 = [{k: v.float() for k, v in layer.items()}
                for layer in _params()]
    h = _rand(2, 7).float()

    def counts(fn):
        before = (mlp.FUSED_LAYERS, mlp.ATEN_TANH_LAYERS, mlp.PLAIN_LAYERS)
        fn()
        return (mlp.FUSED_LAYERS - before[0],
                mlp.ATEN_TANH_LAYERS - before[1],
                mlp.PLAIN_LAYERS - before[2])

    def under_jacfwd(acts, dtype=torch.float32):
        return lambda: jacfwd(lambda x: mlp.mlp_apply(params32, x, acts,
                                                      dtype))(h)
    assert counts(under_jacfwd(ACTS)) == (2, 0, 1)
    assert counts(under_jacfwd(("relu", "relu", "linear"))) == (0, 0, 3)
    assert counts(under_jacfwd(ACTS, torch.bfloat16)) == (0, 0, 3)
    assert counts(lambda: mlp.mlp_apply(params32, h, ACTS)) == (0, 2, 1)
    assert counts(lambda: vmap(grad(lambda x: mlp.mlp_apply(
        params32, x[None], ACTS).sum()))(h)) == (0, 2, 1)


def _route_cases():
    """(name, run(apply)) pairs: each a transform mlp_apply's route meets,
    ``apply(params, rows)`` as the layers."""
    params, h, lam = _params(), _rand(4, 7), _rand(4, 5, seed=2)
    stacked = [{k: torch.stack([v, 1.1 * v]) for k, v in layer.items()}
               for layer in params]
    tracked = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
               for layer in params]

    def blocks(prm):
        return lambda apply: _blocks(apply, prm, h, lam)
    return {
        "jacfwd_over_vjp": (2, blocks(params)),
        "per_member_weights": (0, lambda apply: vmap(
            lambda prm: _blocks(apply, prm, h, lam))(stacked)),
        "weights_tracked_by_autograd": (0, blocks(tracked)),
        "grad_over_jacfwd": (0, lambda apply: grad(lambda x: jacfwd(
            lambda z: apply(params, z))(x).square().sum())(h)),
        "vmap_of_grad": (0, lambda apply: vmap(grad(
            lambda x: apply(params, x[None]).sum()))(h)),
    }


@pytest.mark.parametrize("case", list(_route_cases()))
def test_route_decision(case):
    """mlp_apply takes TanhLayers only where the tangent passes fold into
    the kernels (one forward-mode transform, only vmap levels outside it,
    plain weights), and ATen ops elsewhere; both routes give the
    composite's values."""
    fused, run = _route_cases()[case]
    before = mlp.FUSED_LAYERS, mlp.ATEN_TANH_LAYERS
    got = run(_port)
    n_fused = mlp.FUSED_LAYERS - before[0]
    assert (n_fused > 0) == (fused > 0)
    assert (mlp.ATEN_TANH_LAYERS - before[1] > 0) == (fused == 0)
    for a, b in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(run(_composite))):
        _close(a, b)


def test_tangent_passes_refuse_what_they_cannot_fold():
    """A tangent pass under a grad level outside its forward-mode level
    (which would have to differentiate the pass) raises instead of
    running unseen by that level; so does a rule given batched
    weights."""
    W, y, hd = _rand(4, 6), _rand(3, 6, seed=2), _rand(3, 4, seed=3)
    with pytest.raises(RuntimeError, match="fold only vmap levels"):
        grad(lambda w: jvp(lambda h: td.tangent_fwd(h, [y], [w])[0].sum(),
                           (hd,), (hd,))[1])(W)
    stacked = [{k: torch.stack([v, v]) for k, v in layer.items()}
               for layer in _params()]
    h = _rand(2, 7)
    with pytest.raises(ValueError, match="unbatched weights"):
        vmap(lambda p: _fused(p, h))(stacked)
