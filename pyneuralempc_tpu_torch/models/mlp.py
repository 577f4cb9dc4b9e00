"""Feed-forward NN dynamics (the "neural" in neural EMPC).

PyTorch counterpart of ``pyneuralempc_tpu/models/mlp.py``: an MLP over the
concatenated ``[x, u, tvp, p]`` features whose weights are an explicit list
of ``{"w": (in, out), "b": (out,)}`` tensors threaded through the solver as
runtime data.  All H stages run as one batched matmul chain.

Compute dtype: weights are stored in float32; ``compute_dtype=torch.bfloat16``
runs each layer's matmul in bf16 (its input and weights rounded to bf16) and
hands float32 on to the activation and the next layer; the solver's own
linear algebra stays float32 regardless.

Derivative rules: under one forward-mode transform (the stage blocks'
``jacfwd`` over ``vjp``, a dense ``hessian``) with plain weights and on
enough tangent rows (:data:`FUSED_MIN_ELEMENTS`; :func:`_fused_route`
decides) each run of float32 tanh layers is one :class:`TanhLayers`,
whose tangent pass is a GEMM a layer with the tanh's derivative in its
epilogue, and whose vjp, :class:`TanhLayersVJP`, has a tangent pass of a
GEMM a layer with that derivative's in its prologue
(``ops/cuda/tanh_dense.py``: CUDA kernels on the card, their plain
versions on the CPU).  Elsewhere (a plain evaluation, ``grad`` and
``vjp`` alone: the residuals, the line search, training; a transform
over the forward mode; per-member weights or weight tangents) and on
fewer rows the layers run as ATen ops, whose reverse pass is the same
arithmetic (``tanh_backward``, one GEMM) without an
``autograd.Function``'s host cost under ``torch.func`` (several times the
layer's own dispatch).  Every other layer (another activation, the bf16
path, the linear output layer) runs as ATen ops.  ``FUSED_LAYERS``,
``ATEN_TANH_LAYERS`` and ``PLAIN_LAYERS`` count the layers
:func:`mlp_apply` ran each way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from ..core.problem import Dims
from ..ops.cuda import tanh_dense
from .base import DynamicsModel

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    # jax.nn.gelu's default, the tanh approximation (torch's default, the
    # exact erf form, differs by up to 4.7e-4)
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "swish": torch.nn.functional.silu,
    "sigmoid": torch.sigmoid,
    "linear": lambda x: x,
}


FUSED_LAYERS = 0        # float32 tanh layers mlp_apply ran as TanhLayers
ATEN_TANH_LAYERS = 0    # float32 tanh layers it ran as ATen ops (no jvp)
PLAIN_LAYERS = 0        # every other layer (activation, bf16, output)


# The least tangent rows x layer width for which a run of tanh layers
# takes TanhLayers: below it the kernels save the device less than the
# two autograd.Functions a run of layers cost the host under torch.func.
# Warm re-plans of a quadrotor fleet with a 2x256 tanh MLP (H=50, 16
# tangents a stage), both routes in turns on one H100 (PERF.md §6:
# tools/tanh_dense_timing.py --blocks --batch B), ATen ops against the
# Functions: B=1024 (210M rows x width) 251 against 283 ms, B=1280 (262M)
# 477 against 422, B=1536 (315M) 383 against 384, B=1792 (367M) 399
# against 317, B=2048 (419M) 448 against 327.  The rule lies midway
# between B=1024 and B=1280, at B=1152's 236M; the LV MLP's 0.25M rows x
# 32 re-planned 2.4x slower through the Functions.  A faster host moves
# the crossover down.
FUSED_MIN_ELEMENTS = 1152 * 50 * 16 * 256


def _fused_route(feats, layers) -> bool:
    """Whether a run of tanh ``layers`` takes :class:`TanhLayers` on
    ``feats``: where its rules' tangent passes fold into the kernels
    (``tanh_dense.fold_rows``: exactly one ``torch.func`` forward-mode
    transform, only vmap levels outside it, the weights and biases plain;
    an ``autograd.Function``'s jvp rule is not differentiated by an outer
    transform), on enough tangent rows times the widest layer
    (:data:`FUSED_MIN_ELEMENTS`)."""
    rows = tanh_dense.fold_rows(
        feats, [t for layer in layers for t in (layer["w"], layer["b"])])
    return rows is not None and rows * max(
        layer["w"].shape[1] for layer in layers) >= FUSED_MIN_ELEMENTS


def _batch_first(t, d, n):
    """``t`` with its vmap level's dim ``d`` first, expanded to ``n`` where
    the level does not batch it."""
    return t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)


def _unbatched(dims):
    if any(d is not None for d in dims):
        raise ValueError("the tanh layers' rules take unbatched weights: "
                         "mlp_apply runs per-member weights as ATen ops")


def _untangent(tangents):
    if any(t is not None for t in tangents):
        raise ValueError("the tanh layers' rules take no weight or bias "
                         "tangents: mlp_apply runs such layers as ATen ops")


def _tanh_rows(x, W, b):
    """tanh(x W + b) for x (..., K) as one addmm over the rows."""
    z = torch.addmm(b, x.reshape(-1, x.shape[-1]), W)
    return torch.tanh(z).reshape(*x.shape[:-1], W.shape[1])


class TanhLayers(torch.autograd.Function):
    """Consecutive tanh dense layers y_l = tanh(y_{l-1} W_l + b_l), y_0 = h
    (..., K), as ``apply(h, W_1, b_1, ..., W_L, b_L)``; returns (y_1, ...,
    y_L).

    Tangent: ẏ_l = (1 − y_l²) ⊙ (ẏ_{l−1} W_l), kernel K1 a layer
    (``tanh_dense.tangent_fwd``, the layers in one call); the weights and
    biases take no tangents and no vmap level (:func:`_fused_route` runs
    such layers as ATen ops).  Vjp: :class:`TanhLayersVJP` for h, ATen
    ops for the weights and biases.  Every y_l is an output, so that under
    ``jacfwd`` over ``vjp`` each carries its tangent into the vjp, whose
    tangent pass reads it.  One function for the run of layers, not one a
    layer: under ``torch.func`` each ``autograd.Function`` call costs the
    host more than the layer's own ops.  Under ``vmap`` the forward runs
    as ATen ops on the batched rows (:meth:`vmap`)."""

    @staticmethod
    def forward(h, *wb):
        ys = []
        for W, b in zip(wb[0::2], wb[1::2]):
            h = _tanh_rows(h, W, b)
            ys.append(h)
        return tuple(ys)

    @staticmethod
    def vmap(info, in_dims, h, *wb):
        _unbatched(in_dims[1:])
        ys = TanhLayers.forward(_batch_first(h, in_dims[0], info.batch_size),
                                *wb)
        return ys, (0,) * len(ys)

    @staticmethod
    def setup_context(ctx, inputs, outputs):
        h, *wb = inputs
        ctx.save_for_backward(h, *wb[0::2], *outputs)
        ctx.save_for_forward(*wb[0::2], *outputs)
        # no zeros for the weights' missing tangents and the unused
        # outputs' cotangents: each would cost passes at the tangent width
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *gys):
        h, *rest = ctx.saved_tensors
        L = len(rest) // 2
        Ws, ys = rest[:L], rest[L:]
        grads = [None] * (1 + 2 * L)
        if ctx.needs_input_grad[0]:
            # h's cotangent up the layers, a TanhLayersVJP for each run
            # between outputs with cotangents of their own
            c, top = gys[-1], L
            for l in range(L - 2, -1, -1):
                if gys[l] is None:
                    continue
                if c is not None:
                    c = tanh_dense.call(TanhLayersVJP, c, *ys[l + 1:top],
                                        *Ws[l + 1:top])[0] + gys[l]
                else:
                    c = gys[l]
                top = l + 1
            if c is not None:
                grads[0] = tanh_dense.call(TanhLayersVJP, c, *ys[:top],
                                           *Ws[:top])[0]
        if any(ctx.needs_input_grad[1:]):
            c = None
            for l in reversed(range(L)):
                if gys[l] is not None:
                    c = gys[l] if c is None else c + gys[l]
                if c is None:
                    continue
                gz = c * (1 - ys[l] * ys[l])
                gz2 = gz.reshape(-1, gz.shape[-1])
                x = h if l == 0 else ys[l - 1]
                if ctx.needs_input_grad[1 + 2 * l]:
                    grads[1 + 2 * l] = x.reshape(-1, x.shape[-1]).t() @ gz2
                if ctx.needs_input_grad[2 + 2 * l]:
                    grads[2 + 2 * l] = gz2.sum(0)
                c = gz @ Ws[l].t()
        return tuple(grads)

    @staticmethod
    def jvp(ctx, hd, *wbd):
        _untangent(wbd)
        saved = ctx.saved_tensors
        L = len(saved) // 2
        return tuple(tanh_dense.tangent_fwd(hd, saved[L:], saved[:L]))


class TanhLayersVJP(torch.autograd.Function):
    """The cotangents back through consecutive tanh layers, as
    ``apply(g, y_1, ..., y_m, W_1, ..., W_m)``: from g = g_m, the last
    output's cotangent, g_{l−1} = (g_l ⊙ (1 − y_l²)) W_lᵀ; returns (g_0,
    ..., g_{m−1}), g_{l−1} the cotangent of layer l's input.

    Tangent: ġ_{l−1} = (ġ_l ⊙ (1 − y_l²) − 2 y_l ⊙ ẏ_l ⊙ g_l) W_lᵀ,
    kernel K2 a layer (``tanh_dense.tangent_vjp``, the layers in one
    call); the weights take no tangent and no vmap level, as in
    :class:`TanhLayers`.  Every g_l is an output, so that its primal is at
    hand there.  Its own vjp is the vjp of its ATen forward, for
    reverse-over-reverse.  Under ``vmap`` the forward runs as ATen ops on
    the batched rows."""

    @staticmethod
    def forward(g, *yw):
        m = len(yw) // 2
        ys, Ws = yw[:m], yw[m:]
        outs = [None] * m
        for l in reversed(range(m)):
            g = (g * (1 - ys[l] * ys[l])) @ Ws[l].t()
            outs[l] = g
        return tuple(outs)

    @staticmethod
    def vmap(info, in_dims, g, *yw):
        n, m = info.batch_size, len(yw) // 2
        _unbatched(in_dims[1 + m:])
        outs = TanhLayersVJP.forward(
            _batch_first(g, in_dims[0], n),
            *(_batch_first(y, d, n) for y, d in zip(yw[:m], in_dims[1:])),
            *yw[m:])
        return outs, (0,) * m

    @staticmethod
    def setup_context(ctx, inputs, outputs):
        ctx.save_for_backward(*inputs, *outputs)
        ctx.save_for_forward(*inputs, *outputs)
        ctx.set_materialize_grads(False)

    @staticmethod
    def backward(ctx, *cs):
        saved = ctx.saved_tensors
        m = len(cs)
        inputs, outs = saved[:1 + 2 * m], saved[1 + 2 * m:]
        _, pull = torch.func.vjp(TanhLayersVJP.forward, *inputs)
        grads = pull(tuple(torch.zeros_like(o) if c is None else c
                           for c, o in zip(cs, outs)))
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad))

    @staticmethod
    def jvp(ctx, gd, *ywd):
        m = len(ywd) // 2
        _untangent(ywd[m:])
        g, *rest = ctx.saved_tensors
        ys, Ws, outs = rest[:m], rest[m:2 * m], rest[2 * m:]
        gs = [*outs[1:], g]              # each layer's output's cotangent
        return tuple(tanh_dense.tangent_vjp(gd, ywd[:m], gs, ys, Ws))


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float32, device="cuda"):
    """Glorot-uniform init (Keras Dense defaults), drawn from ``generator``
    on its own device and then moved to ``device``."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        W = torch.rand((fan_in, fan_out), generator=generator, dtype=dtype,
                       device=generator.device) * (2.0 * limit) - limit
        params.append({"w": W.to(device),
                       "b": torch.zeros((fan_out,), dtype=dtype,
                                        device=device)})
    return params


def mlp_apply(params, feats, activations: Tuple[str, ...],
              compute_dtype=torch.float32):
    """Apply the MLP to (T, in_dim) features as one batched matmul chain,
    each matmul in ``compute_dtype`` with a float32 result."""
    global FUSED_LAYERS, PLAIN_LAYERS, ATEN_TANH_LAYERS
    if compute_dtype == torch.float32:
        # the kernels take float32, the plain versions any dtype
        fusable = feats.dtype == torch.float32 or feats.device.type == "cpu"
        h, i, n = feats, 0, min(len(params), len(activations))
        while i < n:
            j = i
            while j < n and activations[j] == "tanh":
                j += 1
            if j > i and fusable and _fused_route(h, params[i:j]):
                FUSED_LAYERS += j - i
                wb = [t for layer in params[i:j] for t in (layer["w"],
                                                           layer["b"])]
                h = tanh_dense.call(TanhLayers, h, *wb)[-1]
                i = j
                continue
            if activations[i] == "tanh":
                ATEN_TANH_LAYERS += 1
            else:
                PLAIN_LAYERS += 1
            h = _ACTIVATIONS[activations[i]](h @ params[i]["w"]
                                              + params[i]["b"])
            i += 1
        return h
    PLAIN_LAYERS += len(params)
    h = feats.to(torch.float32)
    for layer, act in zip(params, activations):
        z = torch.matmul(h.to(compute_dtype), layer["w"].to(compute_dtype))
        b = layer["b"].to(compute_dtype).to(torch.float32)
        h = _ACTIVATIONS[act](z.to(torch.float32) + b)
    return h.to(feats.dtype)


@dataclasses.dataclass(frozen=True)
class MLPDynamics(DynamicsModel):
    """MLP over concatenated ``[x, u, tvp, p]`` features.

    ``hidden``: hidden layer widths; ``activation`` applies to all hidden
    layers, the output layer is linear; ``compute_dtype`` is the matmuls'
    dtype (see the module docstring).
    """

    hidden: Tuple[int, ...] = ()
    activation: str = "tanh"
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def make(x_dim: int, u_dim: int, hidden: Sequence[int],
             p_dim: int = 0, tvp_dim: int = 0, activation: str = "tanh",
             compute_dtype: torch.dtype = torch.float32,
             name: str = "mlp") -> "MLPDynamics":
        dims = Dims(x_dim, u_dim, p_dim, tvp_dim)
        hidden = tuple(int(h) for h in hidden)
        activations = tuple([activation] * len(hidden) + ["linear"])

        def fn(x, u, p, tvp, params):
            feats = [x, u]
            if tvp is not None and dims.tvp:
                feats.append(tvp)
            if p is not None and dims.p:
                feats.append(p.expand(x.shape[0], dims.p))
            return mlp_apply(params, torch.cat(feats, dim=-1), activations,
                             compute_dtype)

        return MLPDynamics(fn=fn, dims=dims, name=name, hidden=hidden,
                           activation=activation, compute_dtype=compute_dtype)

    @property
    def layer_sizes(self) -> Tuple[int, ...]:
        in_dim = self.dims.x + self.dims.u + self.dims.tvp + self.dims.p
        return (in_dim,) + self.hidden + (self.dims.x,)

    def init_params(self, generator, device="cuda"):
        return mlp_init(generator, self.layer_sizes, device=device)
