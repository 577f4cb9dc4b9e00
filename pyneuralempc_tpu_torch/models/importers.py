"""Weight importers: Keras .h5 files and torch state_dicts -> the port's
dynamics models and params.

PyTorch counterpart of ``pyneuralempc_tpu/models/importers.py``, with the
same public names and semantics.  The weights are read once into tensors
and the forward is plain PyTorch: nothing of TensorFlow runs at solve time.
The parsing (the model config's JSON and the weight groups' nesting) is the
port's own copy, on ``json``, ``numpy`` and ``h5py``; ``h5py`` is imported
inside the h5 loaders only, so the package imports without it.

* :func:`load_keras_h5` — Sequential Dense stacks and single-chain
  Functional models as an MLP; anything else (branches and merge layers,
  BatchNormalization / LayerNormalization, Rescaling / Normalization,
  multi-input graphs, shared layers) through a small graph interpreter.
* :func:`load_torch_mlp` — an ``nn.Sequential(nn.Linear, …)`` state_dict.
* :func:`load_keras_lstm_h5`, :func:`load_keras_gru_h5` — recurrent nets
  lifted onto :mod:`.rnn`'s models; :func:`load_keras_h5_rolling` — a
  rolling-window net onto :mod:`.rolling`'s.

Layouts: Keras stores a Dense kernel as (in, out), the port's MLP layout,
and a torch ``Linear`` weight as (out, in), transposed here; Keras LSTM
gates come in the order i, f, c, o and GRU gates z, r, h, the order of
:mod:`.rnn`'s Keras-layout cells, so their kernels load as they are.
"""

from __future__ import annotations

import json
from typing import Tuple

import numpy as np
import torch

from ..core.problem import Dims
from .convert import params_from_numpy
from .mlp import MLPDynamics, mlp_apply

# layers that are identity at inference time and may appear in a chain
_SKIP_LAYERS = ("InputLayer", "Dropout")
_MERGE_LAYERS = ("Add", "Subtract", "Average", "Multiply", "Concatenate")
_ACT_FNS = {"tanh": torch.tanh, "relu": torch.relu,
            "linear": lambda v: v, "sigmoid": torch.sigmoid,
            # jax.nn.gelu's default, the tanh approximation
            "gelu": lambda v: torch.nn.functional.gelu(v,
                                                       approximate="tanh"),
            "swish": torch.nn.functional.silu}


def _layer_name(layer):
    return layer.get("name") or layer["config"]["name"]


def _model_layers(cfg):
    return (cfg["config"]["layers"] if isinstance(cfg["config"], dict)
            else cfg["config"])


def _ordered_layers(cfg):
    """Model config -> ordered layer-config list.  Sequential configs list
    their layers in order; a Functional/Model config must be a single chain
    (walked back from its one output layer), else ValueError."""
    top = cfg.get("class_name", "Sequential")
    layers = _model_layers(cfg)
    if top not in ("Functional", "Model"):
        return layers
    by_name = {_layer_name(l): l for l in layers}

    def names_in(node, found):
        """Layer names referenced anywhere in a config node (the legacy
        nested-list format and the keras-tensor dict format alike)."""
        if isinstance(node, str):
            if node in by_name:
                found.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                names_in(v, found)
        elif isinstance(node, (list, tuple)):
            for v in node:
                names_in(v, found)
        return found

    out_spec = cfg["config"].get("output_layers", [])
    flat = names_in(out_spec, [])
    if len(flat) != 1:
        raise ValueError(
            f"functional model must have exactly one output layer, got "
            f"{flat or out_spec}")
    chain, cur, seen = [], flat[0], set()
    while True:
        if cur in seen:
            raise ValueError("cycle in functional model graph")
        seen.add(cur)
        l = by_name[cur]
        chain.append(l)
        ps = [p for p in names_in(l.get("inbound_nodes", []), [])
              if p != cur]
        if not ps:
            break
        if len(set(ps)) > 1:
            raise ValueError(
                f"layer {cur!r} has multiple inputs {sorted(set(ps))}; "
                "only single-chain functional models are importable")
        cur = ps[0]
    return list(reversed(chain))


def _act_fn(name):
    """A Keras activation name -> its torch function."""
    if name not in _ACT_FNS:
        raise ValueError(f"unsupported Keras activation {name!r}")
    return _ACT_FNS[name]


def _check_norm_axis(cls, name, lcfg):
    """BatchNormalization / LayerNormalization / Normalization import the
    feature (last) axis only: the models take 2-D (batch, features)."""
    axis = lcfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        axis = axis[0] if len(axis) == 1 else axis
    if axis not in (-1, 1):
        raise ValueError(
            f"{cls} layer {name!r}: only axis=-1 (features) is "
            f"importable, got axis={axis}")


def _input_width(lcfg):
    """Feature width of an InputLayer config (None if undeclared)."""
    shape = lcfg.get("batch_input_shape") or lcfg.get("batch_shape")
    if not shape or len(shape) != 2 or shape[-1] is None:
        return None
    return int(shape[-1])


def _node_refs(node, by_name):
    """Ordered (layer_name, call_idx) tensor references in one config node:
    the legacy nested lists ``[name, node_idx, tensor_idx(, kwargs)]`` and
    Keras 3's ``{"config": {"keras_history": [name, node_idx,
    tensor_idx]}}``.  Duplicates are kept: one tensor fed twice to a merge
    layer is a legitimate graph."""
    found = []

    def walk(v):
        if isinstance(v, dict):
            cfgd = v.get("config")
            kh = cfgd.get("keras_history") if isinstance(cfgd, dict) else None
            if (isinstance(kh, (list, tuple)) and len(kh) >= 2
                    and isinstance(kh[0], str) and kh[0] in by_name):
                found.append((kh[0], int(kh[1])))
                return
            for vv in v.values():
                walk(vv)
        elif isinstance(v, (list, tuple)):
            if (len(v) >= 3 and isinstance(v[0], str) and v[0] in by_name
                    and isinstance(v[1], int) and isinstance(v[2], int)):
                found.append((v[0], int(v[1])))
                return
            for vv in v:
                walk(vv)

    walk(node)
    return found


def _graph_meta(cfg):
    """Model config -> (topologically sorted call sites, inputs, output
    key).  A call site is ``(key, layer_name, class_name, layer_config,
    parent keys)`` with ``key = "name#i"`` for call i of a layer, so a
    shared layer (applied at several points) has one entry per call, all
    reading one weight group.  ``inputs`` lists ``(input_name, width)`` in
    the model's input declaration order.  A Sequential config becomes a
    chain graph."""
    top = cfg.get("class_name", "Sequential")
    layers = _model_layers(cfg)
    if top not in ("Functional", "Model"):
        meta, prev = [], None
        for l in layers:
            name = _layer_name(l)
            cls = l["class_name"]
            if cls == "InputLayer" and prev is None:
                meta.append((name + "#0", name, cls, l.get("config", {}),
                             ()))
                prev = name + "#0"
                continue
            if prev is None:
                meta.append(("_synth_input#0", "_synth_input",
                             "InputLayer", {}, ()))
                prev = "_synth_input#0"
            meta.append((name + "#0", name, cls, l.get("config", {}),
                         (prev,)))
            prev = name + "#0"
        if not meta:
            raise ValueError("empty Sequential model config")
        in_name, in_cfg = meta[0][1], meta[0][3]
        return meta, [(in_name, _input_width(in_cfg))], meta[-1][0]

    by_name, order = {}, []
    for l in layers:
        by_name[_layer_name(l)] = l
        order.append(_layer_name(l))
    # one parent list per call of each layer (its inbound_nodes entries)
    calls_by_layer = {
        n: [_node_refs(entry, by_name)
            for entry in by_name[n].get("inbound_nodes", [])]
        for n in order}

    inputs = [n for n in order if by_name[n]["class_name"] == "InputLayer"]
    if not inputs:
        raise ValueError("graph import found no InputLayer")
    if len(inputs) > 1:
        # the model's input declaration order, not the file's
        decl = [n for n, _ in
                _node_refs(cfg["config"].get("input_layers", []), by_name)]
        if set(decl) == set(inputs) and len(decl) == len(inputs):
            inputs = decl

    outs = _node_refs(cfg["config"].get("output_layers", []), by_name)
    if len(outs) != 1:
        raise ValueError(
            f"graph import needs exactly one output layer, got "
            f"{outs or cfg['config'].get('output_layers', [])}")

    topo, state = [], {}

    def visit(name, ci):
        st = state.get((name, ci))
        if st == 2:
            return
        if st == 1:
            raise ValueError("cycle in functional model graph")
        state[(name, ci)] = 1
        calls = calls_by_layer[name]
        if calls:
            if ci >= len(calls):
                raise ValueError(
                    f"layer {name!r}: graph references call {ci} but only "
                    f"{len(calls)} inbound node(s) are declared")
            for pn, pci in calls[ci]:
                visit(pn, pci)
        state[(name, ci)] = 2
        topo.append((name, ci))

    visit(*outs[0])
    # an input the output does not depend on would misalign the slices
    for n in inputs:
        if state.get((n, 0)) != 2:
            raise ValueError(
                f"InputLayer {n!r} does not reach the output — remove it "
                "or rewire the graph")

    def key(n, ci):
        return f"{n}#{ci}"

    meta = []
    for n, ci in topo:
        calls = calls_by_layer[n]
        pars = tuple(key(pn, pci) for pn, pci in calls[ci]) if calls else ()
        meta.append((key(n, ci), n, by_name[n]["class_name"],
                     by_name[n].get("config", {}), pars))
    return meta, [(n, _input_width(by_name[n].get("config", {})))
                  for n in inputs], key(*outs[0])


def _one_input(cls, name, pars):
    if len(pars) != 1:
        raise ValueError(f"{cls} layer {name!r} must have exactly one input")


def _parse_graph(cfg, weights):
    """A Functional (or Sequential) graph -> ``(apply, params)``: a small
    interpreter over the config JSON for InputLayer, Dense, Activation,
    Dropout, BatchNormalization (folded to a per-feature affine),
    LayerNormalization (a graph op), Rescaling and Normalization (constant
    affines; ``invert=True`` honoured) and the merge layers Add, Subtract,
    Average, Multiply, Concatenate; shared layers load their weights once;
    each InputLayer of a multi-input graph takes its slice of the
    ``[x | u | tvp | p]`` features, in declaration order.  ``params`` holds
    numpy float32 arrays (None where a LayerNorm lacks gamma or beta);
    ``apply(params, feats, compute_dtype)`` runs on tensors."""
    meta, inputs, out_key = _graph_meta(cfg)
    slices, total_w = {}, None
    if len(inputs) == 1:
        slices[inputs[0][0]] = None
    else:
        off = 0
        for in_name, w in inputs:
            if w is None:
                raise ValueError(
                    f"multi-input graph: InputLayer {in_name!r} declares "
                    "no static feature width (batch_input_shape) — "
                    "cannot map inputs onto the [x|u|tvp|p] block")
            slices[in_name] = (off, w)
            off += w
        total_w = off
    params, specs = {}, []
    f32 = np.float32
    for kkey, name, cls, lcfg, pars in meta:
        if cls == "InputLayer":
            specs.append((kkey, "input", slices[name], pars, name))
        elif cls in _SKIP_LAYERS:
            _one_input(cls, name, pars)
            specs.append((kkey, "identity", None, pars, name))
        elif cls == "Activation":
            if len(pars) != 1:
                raise ValueError(f"Activation {name!r} must have exactly "
                                 "one input")
            a = lcfg.get("activation", "linear")
            _act_fn(a)
            specs.append((kkey, "act", a, pars, name))
        elif cls == "Dense":
            _one_input(cls, name, pars)
            if name not in params:
                grp = _layer_weights(weights, name)
                params[name] = {"w": _var(grp, "kernel").astype(f32),
                                "b": _var(grp, "bias").astype(f32)}
            a = lcfg.get("activation", "linear")
            _act_fn(a)
            specs.append((kkey, "dense", a, pars, name))
        elif cls == "Rescaling":
            # y = x * scale + offset, constants in the config
            _one_input(cls, name, pars)
            params[name] = {
                "scale": np.asarray(lcfg.get("scale", 1.0), dtype=f32),
                "shift": np.asarray(lcfg.get("offset", 0.0), dtype=f32)}
            specs.append((kkey, "affine", None, pars, name))
        elif cls == "Normalization":
            # adapted statistics -> an affine, as inference-time BatchNorm
            _one_input(cls, name, pars)
            _check_norm_axis(cls, name, lcfg)
            if name not in params:
                try:
                    grp = _layer_weights(weights, name, var="mean")
                    mean = np.asarray(_var(grp, "mean"), np.float64)
                    var_ = np.asarray(_var(grp, "variance"), np.float64)
                except (KeyError, ValueError):
                    # statistics passed at construction live in the config
                    if lcfg.get("mean") is None:
                        raise ValueError(
                            f"Normalization layer {name!r} has neither "
                            "adapted weights nor config statistics")
                    mean = np.asarray(lcfg["mean"], np.float64)
                    var_ = np.asarray(lcfg["variance"], np.float64)
                std = np.maximum(np.sqrt(var_), 1e-7)
                if lcfg.get("invert", False):
                    scale, shift = std, mean
                else:
                    scale, shift = 1.0 / std, -mean / std
                params[name] = {"scale": scale.astype(f32),
                                "shift": shift.astype(f32)}
            specs.append((kkey, "affine", None, pars, name))
        elif cls == "BatchNormalization":
            # moving statistics: a fixed per-feature affine, folded here
            _one_input(cls, name, pars)
            _check_norm_axis(cls, name, lcfg)
            if name not in params:
                grp = _layer_weights(weights, name, var="moving_mean")
                mean = _var(grp, "moving_mean")
                var_ = _var(grp, "moving_variance")
                gamma = _var(grp, "gamma",
                             default=np.ones_like(mean))   # scale=False
                beta = _var(grp, "beta",
                            default=np.zeros_like(mean))   # center=False
                eps = float(lcfg.get("epsilon", 1e-3))
                scale = gamma / np.sqrt(var_ + eps)
                params[name] = {"scale": np.asarray(scale, f32),
                                "shift": np.asarray(beta - mean * scale,
                                                    f32)}
            specs.append((kkey, "affine", None, pars, name))
        elif cls == "LayerNormalization":
            # per-sample statistics: a graph op, not foldable.  gamma is
            # absent when scale=False, beta when center=False.
            _one_input(cls, name, pars)
            _check_norm_axis(cls, name, lcfg)
            if name not in params:
                has_scale = lcfg.get("scale", True)
                has_center = lcfg.get("center", True)
                gamma = beta = None
                if has_scale or has_center:
                    grp = _layer_weights(
                        weights, name, var="gamma" if has_scale else "beta")
                    if has_scale:
                        gamma = _var(grp, "gamma").astype(f32)
                    if has_center:
                        beta = _var(grp, "beta").astype(f32)
                params[name] = {"gamma": gamma, "beta": beta}
            specs.append((kkey, "lnorm", float(lcfg.get("epsilon", 1e-3)),
                          pars, name))
        elif cls in _MERGE_LAYERS:
            if len(pars) < 2:
                raise ValueError(f"merge layer {name!r} needs >= 2 inputs")
            axis = lcfg.get("axis", -1) if cls == "Concatenate" else None
            specs.append((kkey, cls.lower(), axis, pars, name))
        else:
            raise ValueError(
                f"unsupported layer {cls!r} in graph import.\n"
                "Supported vocabulary: InputLayer, Dense, Activation, "
                "Dropout, BatchNormalization, LayerNormalization, "
                "Rescaling, Normalization, "
                f"{', '.join(_MERGE_LAYERS)} (shared layers and "
                "multi-input graphs OK).\n"
                "Workarounds: LSTM/GRU stacks -> load_keras_lstm_h5 / "
                "load_keras_gru_h5; sliding-window surrogates -> "
                "load_keras_h5_rolling; Conv1D over a fixed window can "
                "usually be re-exported as an equivalent Dense stack; "
                "other families: re-train/distill the surrogate into the "
                "supported vocabulary (the solver only needs a smooth "
                "R^(x+u+tvp+p) -> R^x map).")

    def apply(prm, feats, cdt):
        if total_w is not None and feats.shape[-1] != total_w:
            raise ValueError(
                f"multi-input graph declares {total_w} total input "
                f"features but the [x|u|tvp|p] block has "
                f"{feats.shape[-1]}")
        vals = {}
        for kkey, kind, extra, pars, name in specs:
            if kind == "input":
                vals[kkey] = (feats if extra is None
                              else feats[:, extra[0]: extra[0] + extra[1]])
            elif kind == "identity":
                vals[kkey] = vals[pars[0]]
            elif kind == "act":
                vals[kkey] = _act_fn(extra)(vals[pars[0]])
            elif kind == "dense":
                v, w = vals[pars[0]], prm[name]["w"]
                if cdt == torch.float32:
                    z = v @ w
                else:   # the matmul in cdt, its result in float32
                    z = (v.to(cdt) @ w.to(cdt)).to(torch.float32)
                vals[kkey] = _act_fn(extra)(z + prm[name]["b"])
            elif kind == "affine":
                vals[kkey] = (vals[pars[0]] * prm[name]["scale"]
                              + prm[name]["shift"])
            elif kind == "lnorm":
                v = vals[pars[0]]
                mean = v.mean(-1, keepdim=True)
                var_ = v.var(-1, unbiased=False, keepdim=True)
                v = (v - mean) * torch.rsqrt(var_ + extra)
                if prm[name]["gamma"] is not None:
                    v = v * prm[name]["gamma"]
                if prm[name]["beta"] is not None:
                    v = v + prm[name]["beta"]
                vals[kkey] = v
            elif kind == "add":
                v = vals[pars[0]]
                for pn in pars[1:]:
                    v = v + vals[pn]
                vals[kkey] = v
            elif kind == "subtract":
                vals[kkey] = vals[pars[0]] - vals[pars[1]]
            elif kind == "average":
                v = vals[pars[0]]
                for pn in pars[1:]:
                    v = v + vals[pn]
                vals[kkey] = v / float(len(pars))
            elif kind == "multiply":
                v = vals[pars[0]]
                for pn in pars[1:]:
                    v = v * vals[pn]
                vals[kkey] = v
            else:   # concatenate
                vals[kkey] = torch.cat([vals[pn] for pn in pars],
                                       dim=extra if extra is not None
                                       else -1)
        return vals[out_key]

    return apply, params


def _var(grp, name, default=None):
    """A variable of a layer's weight group: tf.keras 2.x writes
    ``<name>:0``, Keras 3's legacy-h5 writer ``<name>``."""
    for k in (name + ":0", name):
        if k in grp:
            return np.asarray(grp[k])
    if default is not None:
        return default
    raise KeyError(f"variable {name!r} not in weight group "
                   f"(has {list(grp.keys())})")


def _layer_weights(weights, name, var="kernel"):
    """A layer's weight group, down the writer's nesting: tf2 legacy
    ``<name>/<name>/<var>:0``, Keras 3 functional ``<name>/<name>/<var>``,
    Keras 3 Sequential ``<name>/<model>/<name>/<var>``."""
    grp = weights[name]
    for _ in range(4):
        if var + ":0" in grp or var in grp:
            return grp
        if name in grp:
            grp = grp[name]
            continue
        subs = list(grp.keys())
        if len(subs) == 1:
            grp = grp[subs[0]]
            continue
        break
    raise ValueError(f"cannot locate weights for layer {name!r}")


def _parse_dense_stack(cfg, weights):
    """Ordered Dense params (numpy) and activations from a Sequential or
    single-chain Functional config; an Activation layer folds into the
    Dense before it."""
    params, acts = [], []
    for l in _ordered_layers(cfg):
        cls = l["class_name"]
        if cls in _SKIP_LAYERS:
            continue
        if cls == "Activation":
            if not acts:
                raise ValueError("Activation layer before any Dense layer")
            a = l["config"].get("activation", "linear")
            _act_fn(a)
            acts[-1] = a
            continue
        if cls != "Dense":
            raise ValueError(
                f"unsupported layer {cls!r} in Dense-stack import "
                "(LSTM nets: use load_keras_lstm_h5)")
        a = l["config"].get("activation", "linear")
        _act_fn(a)
        acts.append(a)
        grp = _layer_weights(weights, l["config"]["name"])
        params.append({"w": _var(grp, "kernel"), "b": _var(grp, "bias")})
    if not params:
        raise ValueError("no Dense layers found in h5 model config")
    return params, acts


def load_keras_h5(path: str, x_dim: int, u_dim: int, p_dim: int = 0,
                  tvp_dim: int = 0, compute_dtype=None, out_dim: int = None,
                  device="cuda") -> Tuple[MLPDynamics, list]:
    """Load a tf.keras .h5 into ``(MLPDynamics, params)``, params on
    ``device``.  A Sequential or single-chain Functional Dense stack
    becomes the port's MLP (a list of ``{"w", "b"}``); any other graph the
    interpreter takes (see :func:`_parse_graph`) becomes an MLPDynamics
    whose forward is that graph (params a dict by layer name).  Input and
    output widths are checked against x+u+tvp+p and x (or ``out_dim``)."""
    import h5py

    with h5py.File(path, "r") as f:
        cfg = json.loads(f.attrs["model_config"])
        try:
            params, acts = _parse_dense_stack(cfg, f["model_weights"])
            graph = None
        except ValueError as stack_err:
            # anything beyond a plain Dense stack goes to the interpreter
            try:
                graph, params = _parse_graph(cfg, f["model_weights"])
            except ValueError as graph_err:
                raise ValueError(
                    f"{graph_err} (Dense-stack parse failed first: "
                    f"{stack_err})") from graph_err

    name = f"keras:{path.rsplit('/', 1)[-1]}"
    if graph is None:
        return _wrap([{k: torch.as_tensor(v, dtype=torch.float32)
                       for k, v in layer.items()} for layer in params],
                     acts, x_dim, u_dim, p_dim, tvp_dim, compute_dtype,
                     name=name, out_dim=out_dim, device=device)
    return _wrap_graph(graph, params, x_dim, u_dim, p_dim, tvp_dim,
                       compute_dtype, name=name, out_dim=out_dim,
                       device=device)


def load_torch_mlp(state_dict, x_dim: int, u_dim: int, p_dim: int = 0,
                   tvp_dim: int = 0, activation: str = "tanh",
                   compute_dtype=None,
                   device=None) -> Tuple[MLPDynamics, list]:
    """Convert an ``nn.Sequential(nn.Linear, …)``-style state_dict into the
    port's MLP params.  torch stores a Linear weight as (out, in); it is
    transposed here to the (in, out) matmul layout.  ``activation`` applies
    between the layers (functional activations leave no trace in a
    state_dict).  A tensor keeps its device unless ``device`` names
    another; numpy arrays go to ``device``, the card when it is None."""
    def to_tensor(v):
        if isinstance(v, torch.Tensor):
            v = v.detach()
            return v.to(torch.float32) if device is None else v.to(
                device=device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device="cuda" if device is None else device)

    params = []
    for k, Wt in state_dict.items():
        if not k.endswith(".weight"):
            continue
        W = to_tensor(Wt)
        b = state_dict.get(k[: -len(".weight")] + ".bias")
        b = (W.new_zeros((W.shape[0],)) if b is None
             else to_tensor(b).to(W.device))
        params.append({"w": W.T.contiguous(), "b": b})
    acts = [activation] * (len(params) - 1) + ["linear"]
    return _wrap(params, acts, x_dim, u_dim, p_dim, tvp_dim, compute_dtype,
                 name="torch_mlp")


def _wrap(params, acts, x_dim, u_dim, p_dim, tvp_dim, compute_dtype, name,
          out_dim=None, device=None):
    """Check a Dense stack's widths and wrap it as an MLPDynamics; params
    (a list of ``{"w", "b"}`` tensors) go to ``device`` unless it is
    None."""
    in_dim = params[0]["w"].shape[0]
    got_out = params[-1]["w"].shape[1]
    expected_out = x_dim if out_dim is None else out_dim
    expected_in = x_dim + u_dim + tvp_dim + p_dim
    if in_dim != expected_in:
        raise ValueError(
            f"model input dim {in_dim} != x+u+tvp+p dims {expected_in}")
    if got_out != expected_out:
        raise ValueError(
            f"model output dim {got_out} != expected {expected_out}")
    for a, b in zip(params[:-1], params[1:]):
        if a["w"].shape[1] != b["w"].shape[0]:
            raise ValueError("inconsistent layer shapes in imported model")

    dims = Dims(x_dim, u_dim, p_dim, tvp_dim)
    cdt = torch.float32 if compute_dtype is None else compute_dtype
    activations = tuple(acts)

    def fn(x, u, p, tvp, prm):
        feats = [x, u]
        if tvp is not None and dims.tvp:
            feats.append(tvp)
        if p is not None and dims.p:
            feats.append(p.expand(x.shape[0], dims.p))
        return mlp_apply(prm, torch.cat(feats, dim=-1), activations, cdt)

    if device is not None:
        params = [{k: v.to(device) for k, v in layer.items()}
                  for layer in params]
    hidden = tuple(int(l["w"].shape[1]) for l in params[:-1])
    model = MLPDynamics(fn=fn, dims=dims, name=name, hidden=hidden,
                        activation=acts[0] if acts else "linear",
                        compute_dtype=cdt)
    return model, params


def _graph_params(params, device):
    """The graph's numpy params as float32 tensors on ``device`` (None
    stays None)."""
    return {name: {k: None if v is None else torch.as_tensor(
        v, dtype=torch.float32, device=device) for k, v in grp.items()}
        for name, grp in params.items()}


def _wrap_graph(graph_apply, params, x_dim, u_dim, p_dim, tvp_dim,
                compute_dtype, name, out_dim=None, device="cuda"):
    """Wrap a graph's forward as an MLPDynamics (the contract of
    :func:`_wrap`); its widths are checked by one evaluation on a zero
    (1, x+u+tvp+p) input on the CPU, before the params go to ``device``."""
    dims = Dims(x_dim, u_dim, p_dim, tvp_dim)
    cdt = torch.float32 if compute_dtype is None else compute_dtype
    expected_in = x_dim + u_dim + tvp_dim + p_dim
    expected_out = x_dim if out_dim is None else out_dim
    out = graph_apply(_graph_params(params, "cpu"),
                      torch.zeros((1, expected_in)), cdt)
    if out.shape[-1] != expected_out:
        raise ValueError(
            f"graph model output dim {out.shape[-1]} != expected "
            f"{expected_out}")

    def fn(x, u, p, tvp, prm):
        feats = [x, u]
        if tvp is not None and dims.tvp:
            feats.append(tvp)
        if p is not None and dims.p:
            feats.append(p.expand(x.shape[0], dims.p))
        return graph_apply(prm, torch.cat(feats, dim=-1), cdt)

    model = MLPDynamics(fn=fn, dims=dims, name=name, hidden=(),
                        activation="graph", compute_dtype=cdt)
    return model, _graph_params(params, device)


def _recurrent_cell_weights(weights, lname, kind):
    """(kernel, recurrent_kernel, bias) of a recurrent layer; tf.keras
    nests them one level deeper, <name>/<name>/{lstm,gru}_cell."""
    grp = weights[lname]
    while "kernel:0" not in grp and "kernel" not in grp:
        subs = list(grp.keys())
        if len(subs) != 1:
            raise ValueError(f"cannot locate {kind} weights under {lname}")
        grp = grp[subs[0]]
    return (_var(grp, "kernel"), _var(grp, "recurrent_kernel"),
            _var(grp, "bias"))


def _recurrent_layers(f, kind, exactly_one):
    """The recurrent layers' configs, the readout Dense's weights and the
    model's weight groups of an open h5 file, checked: ``kind`` layers (one
    when ``exactly_one``, else one or more) and one linear Dense."""
    layers = _ordered_layers(json.loads(f.attrs["model_config"]))
    rec = [l for l in layers if l["class_name"] == kind]
    dense = [l for l in layers if l["class_name"] == "Dense"]
    if (len(rec) != 1 if exactly_one else len(rec) < 1) or len(dense) != 1:
        raise ValueError(
            (f"expected exactly one {kind} and one Dense layer"
             if exactly_one else
             f"expected one or more {kind} layers and one Dense layer")
            + f", got {len(rec)} {kind} / {len(dense)} Dense")
    if dense[0]["config"].get("activation", "linear") != "linear":
        raise ValueError(f"{kind} readout Dense must be linear")
    weights = f["model_weights"]
    dgrp = _layer_weights(weights, dense[0]["config"]["name"])
    return rec, _var(dgrp, "kernel"), _var(dgrp, "bias"), weights


def load_keras_lstm_h5(path: str, x_dim: int, u_dim: int,
                       mode: str = "delta", device="cuda"):
    """Load a tf.keras ``LSTM(units) [→ LSTM …] → Dense(x_dim)`` .h5 into a
    lifted :class:`.rnn.LSTMDynamics` (one LSTM layer) or
    :class:`.rnn.StackedLSTMDynamics` (several), with params on ``device``.
    The net reads ``[x_t, u_t]`` each step (the first kernel's input width
    must be x_dim + u_dim) and its hidden state goes out through one linear
    Dense, a state delta (``mode="delta"``) or the next state
    (``"direct"``); the recurrent carries join the MPC state."""
    import h5py

    from .rnn import lstm_dynamics, stacked_lstm_dynamics

    with h5py.File(path, "r") as f:
        lstm_cfgs, wo, bo, weights = _recurrent_layers(f, "LSTM", False)
        cells = [_recurrent_cell_weights(weights, l["config"]["name"],
                                         "LSTM") for l in lstm_cfgs]

    hiddens = [wr.shape[0] for (_, wr, _) in cells]
    in_dims = [x_dim + u_dim] + hiddens[:-1]
    for li, ((wk, wr, b), nin, nh) in enumerate(zip(cells, in_dims,
                                                    hiddens)):
        if wk.shape != (nin, 4 * nh):
            raise ValueError(
                f"LSTM layer {li} kernel shape {wk.shape} != "
                f"({nin}, {4 * nh}) (layer 0 reads [x, u]; deeper layers "
                f"read the previous layer's hidden state)")
    if wo.shape != (hiddens[-1], x_dim) or bo.shape != (x_dim,):
        raise ValueError(
            f"readout Dense shape {wo.shape} != ({hiddens[-1]}, {x_dim})")

    if len(cells) == 1:
        wk, wr, b = cells[0]
        ld = lstm_dynamics(x_dim=x_dim, u_dim=u_dim, hidden=hiddens[0],
                           mode=mode, name=f"keras_lstm:{path}")
        return ld, params_from_numpy(
            {"wk": wk, "wr": wr, "b": b, "wo": wo, "bo": bo}, device)
    sd = stacked_lstm_dynamics(x_dim=x_dim, u_dim=u_dim, hiddens=hiddens,
                               mode=mode, name=f"keras_stacked_lstm:{path}")
    return sd, params_from_numpy(
        {"layers": [{"wk": wk, "wr": wr, "b": b} for wk, wr, b in cells],
         "wo": wo, "bo": bo}, device)


def load_keras_gru_h5(path: str, x_dim: int, u_dim: int,
                      mode: str = "delta", device="cuda"):
    """Load a tf.keras ``GRU(units) → Dense(x_dim)`` .h5 into a lifted
    Keras-cell GRU model (:func:`.rnn.keras_gru_dynamics`), params on
    ``device``.  Both bias layouts: ``reset_after=True`` (the tf.keras
    default, bias (2, 3u): input and recurrent biases) and
    ``reset_after=False`` (bias (3u,))."""
    import h5py

    from .rnn import keras_gru_dynamics

    with h5py.File(path, "r") as f:
        gru_cfgs, wo, bo, weights = _recurrent_layers(f, "GRU", True)
        wk, wr, b = _recurrent_cell_weights(
            weights, gru_cfgs[0]["config"]["name"], "GRU")
        reset_after = bool(gru_cfgs[0]["config"].get("reset_after",
                                                     b.ndim == 2))

    hidden = wr.shape[0]
    if wk.shape != (x_dim + u_dim, 3 * hidden):
        raise ValueError(
            f"GRU kernel shape {wk.shape} != "
            f"({x_dim + u_dim}, {3 * hidden}) for x+u per-step input")
    if reset_after and b.shape != (2, 3 * hidden):
        raise ValueError(
            f"reset_after GRU bias shape {b.shape} != (2, {3 * hidden})")
    if not reset_after and b.shape != (3 * hidden,):
        raise ValueError(
            f"GRU bias shape {b.shape} != ({3 * hidden},)")
    if wo.shape != (hidden, x_dim) or bo.shape != (x_dim,):
        raise ValueError(
            f"readout Dense shape {wo.shape} != ({hidden}, {x_dim})")

    gd = keras_gru_dynamics(x_dim=x_dim, u_dim=u_dim, hidden=hidden,
                            mode=mode, reset_after=reset_after,
                            name=f"keras_gru:{path}")
    return gd, params_from_numpy(
        {"wk": wk, "wr": wr, "b": b, "wo": wo, "bo": bo}, device)


def load_keras_h5_rolling(path: str, x_dim: int, u_dim: int, window: int,
                          mode: str = "delta", compute_dtype=None,
                          device="cuda"):
    """Load a Keras net that reads a rolling window of states and the
    current control (input width window·x_dim + u_dim, output x_dim) into a
    lifted :class:`.rolling.RollingWindow`; returns (RollingWindow,
    params), params on ``device``."""
    from .rolling import rolling_window

    mlp_model, params = load_keras_h5(path, x_dim=window * x_dim,
                                      u_dim=u_dim,
                                      compute_dtype=compute_dtype,
                                      out_dim=x_dim, device=device)
    rw = rolling_window(mlp_model.fn, x_dim=x_dim, u_dim=u_dim,
                        window=window, mode=mode,
                        name=f"keras_rolling:{path}")
    return rw, params
