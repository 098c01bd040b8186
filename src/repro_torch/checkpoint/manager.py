"""Checkpointing: atomic directories, async commit, retention — the JAX
package's ``checkpoint/manager.py`` with its on-disk layout::

    <dir>/step_000000123/       # one directory per step
        meta.json               # step, leaf keys, time (+ extra)
        shard_0.npz             # one array per leaf, keyed by its path
    <dir>/step_000000123.tmp/   # staging; os.replace() commits atomically

A checkpoint is visible iff its directory name has no ``.tmp`` suffix, so
a killed writer never leaves a half checkpoint that restore would trust.
Leaves are keyed by their path through the tree (``params/layers/attn/
wq``, ``opt/step``, ``opt/m/...``): dict keys, a NamedTuple's field
names and a list's indices, as the JAX package's key paths print.

Tensors go through ``.cpu().numpy()``.  numpy has no bfloat16, so a bf16
leaf is stored as its raw 16 bits (a ``uint16`` array) and its key is
listed under ``"bfloat16"`` in ``meta.json``; restore views the bits as
bfloat16 again.  :class:`AsyncCheckpointer` copies every leaf to the host
before its worker thread starts (the trainer updates its tensors in
place), then serializes and renames on the thread; ``wait()`` joins
before the next save or exit.  Retention keeps the newest ``keep``
checkpoints plus every ``keep_period``-th step.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _items(tree, prefix: str = ""):
    """(key, leaf) pairs of nested dicts / NamedTuples / lists, keyed by
    path; a leaf is a tensor or an array."""
    if isinstance(tree, dict):
        children = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        children = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in children:
        yield from _items(v, f"{prefix}/{k}" if prefix else str(k))


def _rebuild(tree, values: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    def path(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, values, path(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, path(i))
                          for i, v in enumerate(tree))
    return values[prefix]


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (bf16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _host_tree(tree) -> tuple[dict, list[str]]:
    """{key: host array} and the keys of the bf16 leaves."""
    flat, bf16 = {}, []
    for key, leaf in _items(tree):
        flat[key] = _to_host(leaf)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            bf16.append(key)
    return flat, bf16


def _write(directory: str, step: int, flat: dict, bf16: list[str],
           extra: dict | None) -> str:
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
    meta = {"step": step, "keys": sorted(flat), "time": time.time()}
    if bf16:
        meta["bfloat16"] = sorted(bf16)
    meta.update(extra or {})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Synchronous atomic save.  Returns the committed path."""
    flat, bf16 = _host_tree(tree)
    return _write(directory, step, flat, bf16, extra)


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, tree_like, step: int | None = None,
            device: str | torch.device | None = None):
    """Restore into the structure of ``tree_like``: each leaf comes back
    as a new tensor of the like leaf's dtype, on ``device`` (default: the
    like leaf's own device; a ``meta`` tensor serves as a shape-only
    stand-in).  Returns (tree, meta)."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    bf16 = set(meta.get("bfloat16", ()))
    values = {}
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        for key, like in _items(tree_like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            t = torch.from_numpy(np.array(data[key]))
            if key in bf16:
                t = t.view(torch.bfloat16)
            if isinstance(like, torch.Tensor):
                dev = device if device is not None else like.device
                t = t.to(device=dev, dtype=like.dtype)
            values[key] = t
    return _rebuild(tree_like, values), meta


def apply_retention(directory: str, keep: int = 3,
                    keep_period: int = 0) -> list[int]:
    """Delete old checkpoints; returns the steps removed."""
    steps = available_steps(directory)
    protect = set(steps[-keep:]) if keep else set()
    if keep_period:
        protect |= {s for s in steps if s % keep_period == 0}
    removed = []
    for s in steps:
        if s not in protect:
            shutil.rmtree(os.path.join(directory, f"step_{s:09d}"))
            removed.append(s)
    return removed


@dataclass
class AsyncCheckpointer:
    directory: str
    keep: int = 3
    keep_period: int = 0
    _thread: threading.Thread | None = field(default=None, repr=False)
    _error: list = field(default_factory=list, repr=False)

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()
        # host copies before the thread starts: the trainer updates its
        # tensors in place on the next step
        flat, bf16 = _host_tree(tree)

        def work():
            try:
                _write(self.directory, step, flat, bf16, extra)
                apply_retention(self.directory, self.keep, self.keep_period)
            except Exception as e:          # surfaced on next wait()
                self._error.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()
