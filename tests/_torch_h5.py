"""Keras-format .h5 fixtures for the importer tests, written by hand with
h5py (no TensorFlow): a ``model_config`` JSON attribute and the weights
under ``model_weights/<layer>/<layer>/<var>:0``, the layout tf.keras 2.x
writes (recurrent layers one level deeper, ``<layer>/<layer>/<cell>``).
Every writer draws its weights from a seeded numpy generator."""

import json

import numpy as np


def node(*parents):
    """One call's inbound node in the legacy nested-list format; a parent
    is a layer name (its first call) or (name, call index)."""
    return [[[p, 0, 0, {}] if isinstance(p, str) else [p[0], p[1], 0, {}]
             for p in parents]]


def _write(path, cfg, weights):
    """``weights``: {layer: {var: array}} (or {layer: (cell, {var: array})}
    for a recurrent layer's nested cell group)."""
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(cfg)
        w = f.create_group("model_weights")
        for name, vars_ in weights.items():
            g = w.create_group(name).create_group(name)
            if isinstance(vars_, tuple):
                g = g.create_group(vars_[0])
                vars_ = vars_[1]
            for var, data in vars_.items():
                g.create_dataset(var + ":0", data=np.asarray(data, "f4"))


def _dense(rng, fi, fo):
    return {"kernel": rng.normal(0, 0.4, (fi, fo)),
            "bias": rng.normal(0, 0.1, fo)}


def _functional(layers, inputs, output):
    return {"class_name": "Functional",
            "config": {"name": "model", "layers": layers,
                       "input_layers": [[n, 0, 0] for n in inputs],
                       "output_layers": [[output, 0, 0]]}}


def _layer(cls, name, inbound, **config):
    return {"class_name": cls, "name": name,
            "config": dict(name=name, **config), "inbound_nodes": inbound}


def write_sequential(path, sizes, acts, seed=0):
    """Sequential([Dense, ...]): widths ``sizes``, activations ``acts``."""
    rng = np.random.default_rng(seed)
    names = ["dense" if i == 0 else f"dense_{i}"
             for i in range(len(sizes) - 1)]
    cfg = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Dense", "config": {"name": n, "activation": a}}
        for n, a in zip(names, acts)]}}
    _write(path, cfg, {n: _dense(rng, fi, fo)
                       for n, fi, fo in zip(names, sizes[:-1], sizes[1:])})


def write_functional_chain(path, sizes, acts, branch=False, seed=0):
    """A single-chain Functional model (InputLayer -> Dense ...); with
    ``branch`` the last Dense takes two inputs, an invalid graph."""
    rng = np.random.default_rng(seed)
    layers = [_layer("InputLayer", "input_1", [])]
    names, prev = [], "input_1"
    for i, a in enumerate(acts):
        name = "dense" if i == 0 else f"dense_{i}"
        layers.append(_layer("Dense", name, node(prev), activation=a))
        names.append(name)
        prev = name
    if branch:
        layers[-1]["inbound_nodes"] = node("input_1", names[0])
    _write(path, _functional(layers, ["input_1"], prev),
           {n: _dense(rng, fi, fo)
            for n, fi, fo in zip(names, sizes[:-1], sizes[1:])})


def write_branching(path, seed=11):
    """input(3) -> d1 = Dense(8, tanh) -> d2 = Dense(3) -> Add([input, d2])
    -> Concatenate([add, d1]) -> out = Dense(2): a skip connection and
    both merge kinds."""
    rng = np.random.default_rng(seed)
    layers = [_layer("InputLayer", "input_1", []),
              _layer("Dense", "d1", node("input_1"), activation="tanh"),
              _layer("Dense", "d2", node("d1"), activation="linear"),
              _layer("Add", "add", node("input_1", "d2")),
              _layer("Concatenate", "cat", node("add", "d1"), axis=-1),
              _layer("Dense", "out", node("cat"), activation="linear")]
    _write(path, _functional(layers, ["input_1"], "out"),
           {"d1": _dense(rng, 3, 8), "d2": _dense(rng, 8, 3),
            "out": _dense(rng, 11, 2)})


def write_norms(path, seed=13):
    """input(3) -> Rescaling(0.5, 0.1) -> Normalization (adapted) ->
    Dense(8, tanh) -> BatchNormalization -> Dense(6, swish) ->
    BatchNormalization(scale=False) -> LayerNormalization -> Dense(5,
    gelu) -> LayerNormalization(scale=False) -> Dense(4, sigmoid) ->
    Normalization(invert=True, statistics in the config) -> Dense(2)."""
    rng = np.random.default_rng(seed)
    L = [_layer("InputLayer", "input_1", []),
         _layer("Rescaling", "resc", node("input_1"), scale=0.5,
                offset=0.1),
         _layer("Normalization", "norm", node("resc"), axis=-1),
         _layer("Dense", "d1", node("norm"), activation="tanh"),
         _layer("BatchNormalization", "bn1", node("d1"), axis=-1,
                epsilon=1e-3),
         _layer("Dense", "d2", node("bn1"), activation="swish"),
         _layer("BatchNormalization", "bn2", node("d2"), axis=-1,
                epsilon=1e-3, scale=False),
         _layer("LayerNormalization", "ln1", node("bn2"), axis=-1,
                epsilon=1e-3),
         _layer("Dense", "d3", node("ln1"), activation="gelu"),
         _layer("LayerNormalization", "ln2", node("d3"), axis=-1,
                epsilon=1e-3, scale=False),
         _layer("Dense", "d4", node("ln2"), activation="sigmoid"),
         _layer("Normalization", "denorm", node("d4"), axis=-1,
                invert=True, mean=list(rng.normal(0, 0.5, 4)),
                variance=list(rng.uniform(0.5, 2.0, 4))),
         _layer("Dense", "out", node("denorm"), activation="linear")]
    w = {"norm": {"mean": rng.normal(0, 0.3, 3),
                  "variance": rng.uniform(0.5, 2.0, 3)},
         "d1": _dense(rng, 3, 8),
         "bn1": {"gamma": rng.uniform(0.5, 1.5, 8),
                 "beta": rng.normal(0, 0.1, 8),
                 "moving_mean": rng.normal(0, 0.2, 8),
                 "moving_variance": rng.uniform(0.5, 2.0, 8)},
         "d2": _dense(rng, 8, 6),
         "bn2": {"beta": rng.normal(0, 0.1, 6),
                 "moving_mean": rng.normal(0, 0.2, 6),
                 "moving_variance": rng.uniform(0.5, 2.0, 6)},
         "ln1": {"gamma": rng.uniform(0.5, 1.5, 6),
                 "beta": rng.normal(0, 0.1, 6)},
         "d3": _dense(rng, 6, 5),
         "ln2": {"beta": rng.normal(0, 0.1, 5)},
         "d4": _dense(rng, 5, 4),
         "out": _dense(rng, 4, 2)}
    _write(path, _functional(L, ["input_1"], "out"), w)


def write_multi_input_shared(path, seed=17, x_width=2):
    """Two inputs, x (``x_width``, declared second in the file, first in
    the model) and u (1): lift = Dense(2)(u); a SHARED Dense "sh" (2 -> 4,
    tanh) applied to x and to lift; Average and Multiply of its two calls
    concatenated -> out = Dense(2)."""
    rng = np.random.default_rng(seed)
    L = [_layer("InputLayer", "in_u", [], batch_input_shape=[None, 1]),
         _layer("InputLayer", "in_x", [],
                batch_input_shape=[None, x_width]),
         _layer("Dense", "lift", node("in_u"), activation="linear"),
         _layer("Dense", "sh", node("in_x") + node("lift"),
                activation="tanh"),
         _layer("Average", "avg", node(("sh", 0), ("sh", 1))),
         _layer("Multiply", "mul", node(("sh", 0), ("sh", 1))),
         _layer("Subtract", "sub", node("avg", "mul")),
         _layer("Concatenate", "cat", node("avg", "sub"), axis=-1),
         _layer("Dense", "out", node("cat"), activation="linear")]
    _write(path, _functional(L, ["in_x", "in_u"], "out"),
           {"lift": _dense(rng, 1, 2), "sh": _dense(rng, 2, 4),
            "out": _dense(rng, 8, 2)})


def write_lstm(path, in_dim, units, out_dim, seed=5):
    """Sequential([LSTM(u) for u in units] + [Dense(out_dim)]): one LSTM
    layer or a stack; gate order i, f, c, o."""
    rng = np.random.default_rng(seed)
    layers, w, prev = [], {}, in_dim
    for li, u in enumerate(units):
        name = "lstm" if li == 0 else f"lstm_{li}"
        layers.append({"class_name": "LSTM",
                       "config": {"name": name, "units": u}})
        w[name] = ("lstm_cell", {
            "kernel": rng.normal(0, 0.4, (prev, 4 * u)),
            "recurrent_kernel": rng.normal(0, 0.4, (u, 4 * u)),
            "bias": rng.normal(0, 0.1, 4 * u)})
        prev = u
    layers.append({"class_name": "Dense",
                   "config": {"name": "dense", "activation": "linear"}})
    w["dense"] = _dense(rng, prev, out_dim)
    _write(path, {"class_name": "Sequential", "config": {"layers": layers}},
           w)


def write_gru(path, in_dim, units, out_dim, reset_after=True, seed=7):
    """Sequential([GRU(units), Dense(out_dim)]); gate order z, r, h; bias
    (2, 3u) with ``reset_after`` (input and recurrent biases), else
    (3u,)."""
    rng = np.random.default_rng(seed)
    cfg = {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "GRU", "config": {"name": "gru", "units": units,
                                         "reset_after": reset_after}},
        {"class_name": "Dense",
         "config": {"name": "dense", "activation": "linear"}}]}}
    bias = rng.normal(0, 0.1, (2, 3 * units) if reset_after else 3 * units)
    _write(path, cfg, {
        "gru": ("gru_cell", {
            "kernel": rng.normal(0, 0.4, (in_dim, 3 * units)),
            "recurrent_kernel": rng.normal(0, 0.4, (units, 3 * units)),
            "bias": bias}),
        "dense": _dense(rng, units, out_dim)})
