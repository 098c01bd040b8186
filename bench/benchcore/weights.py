"""The weights of a cell, made by the benchmark from ``--seed`` and handed
to the port and to the plain reference alike.

A llama-layout decoder (the layout the port's ``models/transformer.py``
reads): ``embed`` (V, d); ``layers`` stacked along a leading (L, ...)
axis: ``norm1_w``, ``norm2_w``, ``attn`` {``wq``, ``wk``, ``wv``, ``wo``}
and ``mlp`` {``w_up``, ``w_down``, ``w_gate``}, used as ``x @ W``;
``final_norm_w`` and ``lm_head`` (d, V).  Norm weights are ones, the
embedding is Normal(0, 0.02), every product's weight Uniform(-1/sqrt(fan
in), 1/sqrt(fan in)).

Each leaf is one ``torch.Generator`` call on the device, in the dtype it
is used in, from a seed of its own (the run's seed and the leaf's index),
so that one leaf can be made again alone: the training check rebuilds
the initial parameters leaf by leaf to measure how far they moved.
"""
from __future__ import annotations

import math

import torch

_MASK63 = (1 << 63) - 1


def dims(conf: dict) -> dict:
    """The sizes the layout needs, from a configuration file's keys."""
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    dh = conf.get("head_dim") or d // h
    v = conf["vocab_size"]
    return {"L": conf["num_hidden_layers"], "d": d, "H": h,
            "Hkv": conf["num_key_value_heads"], "Dh": dh,
            "ff": conf["intermediate_size"], "V": v + (-v) % 128,
            "eps": conf["rms_norm_eps"], "theta": conf["rope_theta"]}


def leaf_specs(conf: dict) -> list[tuple]:
    """(path, shape, init, scale) of every leaf, in the port's order."""
    m = dims(conf)
    L, d, ff, V = m["L"], m["d"], m["ff"], m["V"]
    hq, hkv = m["H"] * m["Dh"], m["Hkv"] * m["Dh"]
    u = lambda fan_in: 1.0 / math.sqrt(fan_in)
    return [
        (("embed",), (V, d), "normal", 0.02),
        (("layers", "norm1_w"), (L, d), "ones", None),
        (("layers", "norm2_w"), (L, d), "ones", None),
        (("layers", "attn", "wq"), (L, d, hq), "uniform", u(d)),
        (("layers", "attn", "wk"), (L, d, hkv), "uniform", u(d)),
        (("layers", "attn", "wv"), (L, d, hkv), "uniform", u(d)),
        (("layers", "attn", "wo"), (L, hq, d), "uniform", u(hq)),
        (("layers", "mlp", "w_up"), (L, d, ff), "uniform", u(d)),
        (("layers", "mlp", "w_down"), (L, ff, d), "uniform", u(ff)),
        (("layers", "mlp", "w_gate"), (L, d, ff), "uniform", u(d)),
        (("final_norm_w",), (d,), "ones", None),
        (("lm_head",), (d, V), "uniform", u(d)),
    ]


def leaf_seed(seed: int, index: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) \
        & _MASK63


def make_leaf(spec: tuple, seed: int, index: int, device,
              dtype: torch.dtype) -> torch.Tensor:
    _, shape, init, scale = spec
    t = torch.empty(shape, dtype=dtype, device=device)
    if init == "ones":
        return t.fill_(1.0)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    if init == "normal":
        return t.normal_(0.0, scale, generator=gen)
    return t.uniform_(-scale, scale, generator=gen)


def put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def get(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def make_weights(conf: dict, seed: int, device,
                 dtype: torch.dtype) -> dict:
    """Every leaf of ``conf``'s model from ``seed``, on ``device``."""
    tree: dict = {}
    for i, spec in enumerate(leaf_specs(conf)):
        put(tree, spec[0], make_leaf(spec, seed, i, device, dtype))
    return tree


def slices(conf: dict) -> list[tuple]:
    """The leaves a training check compares, each (name, path, layer):
    the stacked leaves layer by layer (layer ``None``: the whole leaf)."""
    out = []
    L = dims(conf)["L"]
    for path, shape, _, _ in leaf_specs(conf):
        if path[0] == "layers":
            out += [(".".join(path) + f"[{i}]", path, i) for i in range(L)]
        else:
            out.append((".".join(path), path, None))
    return out
