"""The tangent passes of tanh dense layers: two CUDA kernels, their plain
PyTorch versions, and the folding that brings ``torch.func``'s batched
tangents to them.

A tanh dense layer y = tanh(h W + b) under forward-mode differentiation
(``torch.func.jacfwd``, ``jvp``) needs, for T tangents ḣ of each primal
row h,

* **K1**, the forward tangent:  ẏ = (1 − y²) ⊙ (ḣ W);
* **K2**, the tangent of its vjp g_h = (g_y ⊙ (1 − y²)) Wᵀ:
  ġ_h = (ġ_y ⊙ (1 − y²) − 2 y ⊙ ẏ ⊙ g_y) Wᵀ.

Each is one GEMM over the P·T tangent rows whose epilogue (K1) or prologue
(K2) reads the primal rows y, g_y of row p = r / T, shared by that row's T
tangents.  Composed from ATen ops under ``torch.func``, the same rules take
a dozen elementwise passes and copies at the tangent width (bias adds,
``tanh_backward`` on a broadcast primal, the products and sums of its
jvp); the kernels keep the pre-activation tangent and every such
intermediate out of device memory.

Replaces no TPU kernel: the JAX package leaves these passes to XLA's
fusion.  ``csrc/tanh_dense.cu`` holds both, bound by float32 FFMA issue
at the widths the stage blocks take (K, N of 256: 2·K·N flops against
4·(K + N) bytes a row); its design is in the source's head comment.

:func:`tangent_fwd` and :func:`tangent_vjp` take a run of layers' tangents
as ``models/mlp.py``'s ``TanhLayers`` and ``TanhLayersVJP`` rules hand
them over: rows (..., X), batched by any ``vmap`` levels.
:func:`_batched_call` takes the plain tensors from under the levels and
folds each level into rows, primal-row-major (row r = p·T + t): a level
that batches a primal multiplies the P rows, a level that batches only
tangents (``jacfwd``'s basis) the T tangents of a row.  The fold is a view
of the tangents at the layouts the stage blocks make (one primal row a
stage), and the kernels read any strides, so no tangent is copied before
a kernel reads it.  The run's layers then go through their kernels in one
call, and the outputs come back batched as the inputs were.  The fold
takes only vmap levels under one forward-mode level, and plain weights:
``models/mlp.py`` asks :func:`fold_rows` before it takes the rules, and
runs the layers as ATen ops elsewhere (an outer ``grad`` or ``jvp``,
per-member weights, weight tangents); :func:`tangent_fwd` and
:func:`tangent_vjp` raise on inputs the fold cannot take.

The fold and :func:`call` are this port's only use of ``torch.func``'s
internals (``torch._C._functorch``'s wrappers and interpreter stack,
``temporarily_clear_interpreter_stack``, ``custom_function_call``), as
torch 2.11 to 2.13 have them; ``tests/test_torch_mlp_rules.py`` holds the
rules that use them against ATen ops.

``K1_LAUNCHES`` and ``K2_LAUNCHES`` count kernel launches; ``PLAIN_CALLS``
counts calls of a plain version (CPU tensors).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch._functorch.autograd_function import custom_function_call
from torch._functorch.pyfunctorch import (
    temporarily_clear_interpreter_stack)

SOURCE = "tanh_dense.cu"

K1_LAUNCHES = 0     # tanh_tangent_fwd_f32 launches (ẏ)
K2_LAUNCHES = 0     # tanh_tangent_vjp_f32 launches (ġ_h)
PLAIN_CALLS = 0     # calls of tangent_fwd_plain / tangent_vjp_plain


def launch_counts() -> dict:
    """The kernels' launch counts so far, by name."""
    return {"k1_launches": K1_LAUNCHES, "k2_launches": K2_LAUNCHES}


# ---- plain versions ----

def tangent_fwd_plain(hd, y, W):
    """K1 in PyTorch: hd (P, T, K), y (P, N), W (K, N) -> (P, T, N)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return torch.matmul(hd, W) * (1 - y * y).unsqueeze(-2)


def tangent_vjp_plain(gd, yd, g, y, W):
    """K2 in PyTorch: gd, yd (P, T, N) or None (a zero tangent), g, y
    (P, N), W (K, N) -> (P, T, K)."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    a = 0
    if gd is not None:
        a = gd * (1 - y * y).unsqueeze(-2)
    if yd is not None:
        a = a - 2 * yd * (y * g).unsqueeze(-2)
    return torch.matmul(a, W.t())


# ---- CUDA wrappers ----

_ENTRIES = {}


def _entry(name, n_ptrs, n_ints):
    """The C entry ``name`` of ``csrc/tanh_dense.cu``: ``n_ptrs`` pointers,
    ``n_ints`` 64-bit ints (dims, strides), the device, then the stream."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from .build import load
        fn = getattr(load(SOURCE), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_longlong] * n_ints
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _check(dev, **tensors):
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def _primal(t, P, N, name):
    if tuple(t.shape) != (P, N):
        raise ValueError(f"{name} must have shape {(P, N)}, got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def _tangent(t, P, T, X, name):
    if t is not None and tuple(t.shape) != (P, T, X):
        raise ValueError(f"{name} must have shape {(P, T, X)}, got "
                         f"{tuple(t.shape)}")


def _strides(t):
    """``t``'s strides, 0 along a dim of one (whose stride is arbitrary),
    so that the kernels see the rows' true layout."""
    if t is None:
        return (0, 0, 0)
    return tuple(0 if n == 1 else s for n, s in zip(t.shape, t.stride()))


def _raise_on(err, entry, shape):
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"(P, T, K, N = {shape})")


def tangent_fwd_cuda(hd, y, W):
    """Launch K1 on CUDA float32 tensors (no fallback): hd (P, T, K) of any
    strides, y (P, N), W (K, N); returns ẏ (P, T, N), contiguous."""
    global K1_LAUNCHES
    P, T, K = hd.shape
    N = W.shape[1]
    _check(hd.device, hd=hd, y=y, W=W)
    y = _primal(y, P, N, "y")
    W = _primal(W, K, N, "W")
    out = torch.empty((P, T, N), dtype=torch.float32, device=hd.device)
    if out.numel():
        err = _entry("tanh_tangent_fwd_f32", 4, 7)(
            hd.data_ptr(), y.data_ptr(), W.data_ptr(), out.data_ptr(),
            P, T, K, N, *_strides(hd), hd.device.index or 0,
            torch.cuda.current_stream(hd.device).cuda_stream)
        _raise_on(err, "tanh_tangent_fwd_f32", (P, T, K, N))
    K1_LAUNCHES += 1
    return out


def tangent_vjp_cuda(gd, yd, g, y, W):
    """Launch K2 on CUDA float32 tensors (no fallback): gd, yd (P, T, N) of
    any strides, either None for a zero tangent, g, y (P, N), W (K, N);
    returns ġ_h (P, T, K), contiguous."""
    global K2_LAUNCHES
    P, T, N = (gd if gd is not None else yd).shape
    K = W.shape[0]
    _tangent(gd, P, T, N, "gd")
    _tangent(yd, P, T, N, "yd")
    _check(y.device, gd=gd, yd=yd, g=g, y=y, W=W)
    g = _primal(g, P, N, "g")
    y = _primal(y, P, N, "y")
    W = _primal(W, K, N, "W")
    out = torch.empty((P, T, K), dtype=torch.float32, device=y.device)
    if out.numel():
        err = _entry("tanh_tangent_vjp_f32", 6, 10)(
            None if gd is None else gd.data_ptr(),
            None if yd is None else yd.data_ptr(),
            g.data_ptr(), y.data_ptr(), W.data_ptr(), out.data_ptr(),
            P, T, K, N, *_strides(gd), *_strides(yd), y.device.index or 0,
            torch.cuda.current_stream(y.device).cuda_stream)
        _raise_on(err, "tanh_tangent_vjp_f32", (P, T, K, N))
    K2_LAUNCHES += 1
    return out


# ---- batched tangents ----

_F = torch._C._functorch


def call(fn, *args):
    """``fn.apply(*args)`` for an ``autograd.Function`` ``fn``; under
    ``torch.func`` straight to its dispatch, which is where ``apply`` sends
    it after binding the arguments by signature (~0.2 ms of the host's
    time a call)."""
    if torch._C._are_functorch_transforms_active():
        return custom_function_call(fn, *args)
    return fn.apply(*args)


def fold_rows(feats, tensors):
    """The tangent rows a tangent pass on rows ``feats`` (..., X) folds
    (their rows times every vmap level's batch), or None where the fold
    cannot take the pass: it takes exactly one forward-mode ``torch.func``
    level with only vmap levels outside it (an outer ``grad`` or ``jvp``
    would have to differentiate the pass itself), ``tensors`` (the layers'
    weights and biases) plain (no vmap level, no tangent, no autograd),
    and ``feats`` untracked by autograd under its wrappers."""
    if not torch._C._are_functorch_transforms_active():
        return None
    vmaps, jvp = [], False
    for i in _F.get_interpreter_stack():
        key = i.key()
        if key == _F.TransformType.Vmap:
            vmaps.append(i)
        elif key == _F.TransformType.Jvp and not jvp:
            jvp = True
        elif not (key == _F.TransformType.Grad and jvp):
            return None
    if not jvp or any(_F.is_functorch_wrapped_tensor(t) or t.requires_grad
                      for t in tensors):
        return None
    base = feats
    while _F.is_functorch_wrapped_tensor(base):
        base = _F.get_unwrapped(base)
    if base.requires_grad:
        return None
    return math.prod((_F.CVmapInterpreterPtr(i).batchSize() for i in vmaps),
                     start=feats.numel() // max(feats.shape[-1], 1))


def _peel(t, top):
    """``t`` under its ``torch.func`` wrappers: ``(chain, base)``, ``base``
    the plain tensor and ``chain`` its vmap levels and batch dims, the
    outermost wrapper's first.  A wrapper of the forward-mode level ``top``
    (whose rule is running, so the tensor is its primal value there) comes
    off first.  None where another wrapper (an outer grad or jvp level's)
    is in the way, which :func:`fold_rows` keeps from here."""
    if t is None:
        return [], None
    if top is not None and _F.is_gradtrackingtensor(t) \
            and _F.maybe_get_level(t) == top:
        t = _F.get_unwrapped(t)
    chain = []
    while _F.is_batchedtensor(t):
        chain.append((_F.maybe_get_level(t), _F.maybe_get_bdim(t)))
        t = _F.get_unwrapped(t)
    if _F.is_functorch_wrapped_tensor(t) or t.requires_grad:
        return None
    return chain, t


def _levels_first(chain, t):
    """The plain tensor ``t`` of :func:`_peel` with one dim a vmap level
    first, ascending, then the wrapped tensor's own shape."""
    for k, (_, bdim) in enumerate(reversed(chain)):
        if bdim:
            t = t.movedim(k + bdim, k)
    return [level for level, _ in reversed(chain)], t


def _spread(levels, all_levels, t, sizes):
    """``t`` (``levels``' dims, then its own) with a dim for each of
    ``all_levels``, expanded where it had none."""
    if len(levels) == len(all_levels):
        return t
    for k, level in enumerate(all_levels):
        if level not in levels:
            t = t.unsqueeze(k)
    return t.expand(*sizes, *t.shape[len(all_levels):])


def _fold_run(run, peeled, n_t, n_p):
    """:func:`_batched_call`'s work on plain tensors: returns ``run``'s
    outputs, each with one dim a vmap level first (ascending), then the
    inputs' leading dims and its width; and the levels."""
    peeled = [_levels_first(*p) for p in peeled]
    all_levels = sorted({lv for lvs, _ in peeled for lv in lvs})
    sizes = [None] * len(all_levels)
    for lvs, t in peeled:
        for k, lv in enumerate(lvs):
            sizes[all_levels.index(lv)] = t.shape[k]
    p_levels = {lv for lvs, _ in peeled[n_t:n_t + n_p] for lv in lvs}
    outer = [k for k, lv in enumerate(all_levels) if lv in p_levels]
    inner = [k for k, lv in enumerate(all_levels) if lv not in p_levels]
    L = len(all_levels)
    n_outer = math.prod(sizes[k] for k in outer)
    n_inner = math.prod(sizes[k] for k in inner)
    lead = next(t.shape[len(lvs):-1] for lvs, t in peeled[:n_t]
                if t is not None)
    P = math.prod(lead)
    folded_t = []
    for lvs, t in peeled[:n_t]:
        if t is not None:
            t = t.reshape(*t.shape[:len(lvs)], P, t.shape[-1])
            t = _spread(lvs, all_levels, t, sizes)
            t = t.permute(*outer, L, *inner, L + 1)
            t = t.reshape(n_outer * P, n_inner, t.shape[-1])
        folded_t.append(t)
    outer_levels = [all_levels[k] for k in outer]
    folded_p = [_spread(lvs, outer_levels,
                        t.reshape(*t.shape[:len(lvs)], P, t.shape[-1]),
                        [sizes[k] for k in outer])
                .reshape(n_outer * P, t.shape[-1])
                for lvs, t in peeled[n_t:n_t + n_p]]
    order = outer + [L] + inner + [L + 1]
    back = sorted(range(L + 2), key=order.__getitem__)
    outs = []
    for out in run(folded_t, folded_p, [t for _, t in peeled[n_t + n_p:]]):
        if out is not None:
            Y = out.shape[-1]
            out = out.reshape(*(sizes[k] for k in outer), P,
                              *(sizes[k] for k in inner), Y)
            out = out.permute(*back).reshape(*sizes, *lead, Y)
        outs.append(out)
    return outs, all_levels


def _batched_call(run, tangents, primals, Ws):
    """``run(tangents, primals, Ws)`` on tangents (..., X) and primal rows
    (..., N) of one leading shape and weights (K, N), any of which
    ``torch.func.vmap`` may batch: the leading dims become P rows, each
    vmap level folds into them, primal-row-major (a level that batches a
    primal multiplies the P rows, a level that batches only tangents, as
    ``jacfwd``'s basis does, gives each row T tangents: row r = p·T + t),
    ``run`` takes the (P, T, X) tangents and (P, N) rows once as plain
    tensors, with the transforms' interpreters set aside, and each of its
    (P, T, Y) outputs comes back as (..., Y), batched as the inputs were.
    Raises where an input carries another transform's wrapper (an outer
    grad or jvp level's, which would have to differentiate ``run``) or a
    weight is batched: :func:`fold_rows` keeps such inputs from here."""
    top = _F.peek_interpreter_stack()
    top = (top.level() if top is not None
           and top.key() == _F.TransformType.Jvp else None)
    peeled = [_peel(t, top) for t in (*tangents, *primals, *Ws)]
    if any(p is None or (i >= len(peeled) - len(Ws) and p[0])
           for i, p in enumerate(peeled)):
        raise RuntimeError(
            "the tanh layers' tangent passes fold only vmap levels under "
            "one forward-mode level, with plain weights: models/mlp.py runs "
            "other layers as ATen ops (see fold_rows)")
    with temporarily_clear_interpreter_stack():
        outs, levels = _fold_run(run, peeled, len(tangents), len(primals))
    wrapped = []
    for out in outs:
        if out is not None:
            for level in levels:
                out = _F._add_batch_dim(out, 0, level)
        wrapped.append(out)
    return wrapped


def _fwd_chain(k1, hd, ys, Ws):
    """The tangents of consecutive tanh layers' outputs ``ys`` from the
    first one's input tangent ``hd``."""
    outs = []
    for y, W in zip(ys, Ws):
        hd = k1(hd, y, W)
        outs.append(hd)
    return outs


def _vjp_chain(k2, gd, yds, gs, ys, Ws):
    """The tangents of the cotangents of consecutive tanh layers' inputs,
    from the last one's output cotangent tangent ``gd`` (layer l: ``gs[l]``
    the cotangent of its output ``ys[l]``, ``yds[l]`` that output's
    tangent; None: a zero tangent)."""
    outs = [None] * len(Ws)
    for l in reversed(range(len(Ws))):
        if gd is not None or yds[l] is not None:
            gd = k2(gd, yds[l], gs[l], ys[l], Ws[l])
        outs[l] = gd
    return outs


def _device_fn(cuda_fn, plain_fn, W):
    return plain_fn if W.device.type == "cpu" else cuda_fn


def tangent_fwd(hd, ys, Ws):
    """K1 down consecutive tanh layers, for ``TanhLayers.jvp``: the input
    tangent ``hd`` (..., K) of rows whose layer outputs are ``ys`` (each
    (..., N_l)) under weights ``Ws``, under any vmap levels (the kernel on
    CUDA tensors, the plain version on CPU ones, all layers in one
    :func:`_batched_call`, which raises on inputs the fold cannot take).
    Returns each output's tangent."""
    k1 = _device_fn(tangent_fwd_cuda, tangent_fwd_plain, Ws[0])
    return _batched_call(lambda ts, ps, ws: _fwd_chain(k1, ts[0], ps, ws),
                         (hd,), tuple(ys), tuple(Ws))


def tangent_vjp(gd, yds, gs, ys, Ws):
    """K2 up consecutive tanh layers, for ``TanhLayersVJP.jvp``: from the
    tangent ``gd`` of the last layer's output cotangent, the tangents of
    each layer's input cotangent (layer l: ``gs[l]`` its output's
    cotangent, ``ys[l]`` its output, ``yds[l]`` that output's tangent;
    tangents None where zero), as :func:`tangent_fwd`."""
    m = len(Ws)
    k2 = _device_fn(tangent_vjp_cuda, tangent_vjp_plain, Ws[0])

    def run(ts, ps, ws):
        return _vjp_chain(k2, ts[0], ts[1:], ps[:m], ps[m:], ws)
    return _batched_call(run, (gd, *yds), (*gs, *ys), tuple(Ws))
