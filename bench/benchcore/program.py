"""The adapter to the program under test, the port ``repro_torch``: the
port's model configuration for a benchmark configuration file, checked
field by field against the file, so the program runs the sizes the file
states.  The port is imported inside the functions only."""
from __future__ import annotations

import dataclasses
import sys

from .spec import ROOT

#: top-level modules that may not be loaded in a run's process: JAX and
#: the JAX package the port was made from (``repro``; the port's own name,
#: ``repro_torch``, is another top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the port's fixed RMSNorm epsilon (``models/layers.py``)
PORT_RMS_EPS = 1e-5


def add_program_path(root=ROOT) -> None:
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def port_config(conf: dict, overrides: dict | None = None):
    """The port's ``ArchConfig`` for configuration ``conf`` (its registry
    key, with the file's depth and dtypes); ``overrides`` (CPU tests
    only) replaces fields afterwards, and the check is skipped."""
    from repro_torch.configs import get_arch

    cfg = dataclasses.replace(
        get_arch(conf["registry"]),
        n_layers=conf["num_hidden_layers"],
        param_dtype=conf["param_dtype"],
        compute_dtype=conf["compute_dtype"],
        cache_dtype=conf["cache_dtype"])
    if overrides:
        return dataclasses.replace(cfg, **overrides)
    want = {"d_model": conf["hidden_size"],
            "n_heads": conf["num_attention_heads"],
            "n_kv_heads": conf["num_key_value_heads"],
            "d_ff": conf["intermediate_size"],
            "vocab_size": conf["vocab_size"],
            "rope_theta": float(conf["rope_theta"]),
            "head_dim": conf["hidden_size"] // conf["num_attention_heads"],
            "tie_embeddings": conf["tie_word_embeddings"],
            "act": conf["hidden_act"], "family": "dense",
            "qkv_bias": False, "window": None}
    got = {k: getattr(cfg, k) for k in want}
    got["rope_theta"] = float(got["rope_theta"])
    if got != want or conf["rms_norm_eps"] != PORT_RMS_EPS:
        raise ValueError(f"the port's {conf['registry']!r} is not the "
                         f"configuration file's: {got} against {want}, "
                         f"rms eps {PORT_RMS_EPS} / {conf['rms_norm_eps']}")
    return cfg


def small_conf(conf: dict, layers: int = 2) -> tuple[dict, dict]:
    """A configuration file cut to a CPU test's size and the port's
    overrides that match it (float32 compute, as the port's reduced
    configs): the CPU tests drive a whole run with it."""
    small = dict(conf, hidden_size=64, num_attention_heads=4,
                 num_key_value_heads=min(conf["num_key_value_heads"], 2),
                 intermediate_size=128, vocab_size=256,
                 num_hidden_layers=layers, compute_dtype="float32",
                 cache_dtype="float32", param_dtype="float32",
                 rms_norm_eps=PORT_RMS_EPS)
    over = dict(n_layers=layers, d_model=64, n_heads=4,
                n_kv_heads=small["num_key_value_heads"], d_head=16, d_ff=128,
                vocab_size=256, compute_dtype="float32",
                cache_dtype="float32", param_dtype="float32")
    return small, over
