"""Compiled steps: each step captured once per shape as a CUDA graph and
replayed, the port's counterpart of ``jax.jit``: the serving engine's
every-tick steps (the JAX engine's jitted decode, verify, draft decode
and prompt chunk) and the trainer's step (the JAX trainer's
``jax.jit(build_train_step(...))``: forward, ``torch.autograd.grad``
through K1's and K9's Functions, the float32 microbatch sums, the clip
and AdamW's in-place update, in one graph).

``compile_step(fn, name, per_tick=...)`` returns a :class:`CompiledStep`,
a callable with ``fn``'s signature:

* on CUDA tensors the first call of a key runs ``fn`` itself on the
  step's own capture stream (the warm-up: a real step, its result
  returned and its launches counted as an eager call's), then captures
  ``fn`` into a ``torch.cuda.CUDAGraph`` with a private memory pool (the
  capture executes nothing: a train step's warm-up is its one update);
  every later call of that key copies its per-tick inputs into the
  graph's buffers and replays the graph on the current stream.  Warm-up
  first, so that what a kernel makes at its first launch on a stream
  (the merged split routes' arrival counters, cuBLAS' workspace, a
  library's load) exists before the capture and is not made inside the
  graph's pool;
* on CPU tensors it calls ``fn``: the port's CPU route, chosen by the
  tensor's device as ``kernels.ops`` chooses the kernel or its plain
  version.  A capture that fails raises, naming the step; nothing falls
  back to the eager step.

**The key** of a graph: the structure of the arguments, the shape,
stride, dtype and device of every tensor in them, every non-tensor
argument (``num_splits``, a mesh), what ``at.tuned`` publishes for the
kernels a step reads (:data:`TUNED_KERNELS`; ``kernels.ops`` reads it at
every launch and a graph bakes it in, so a newly published tile gets a
new graph, never a stale one) and a ``_forced_width`` block's width.

**Per-tick inputs and persistent tensors.**  A tensor passed as an
argument itself (the engine's ``token``, ``pos``, page table, ``start``,
``kv_len``, a chunk's tokens), and every tensor at any depth of an
argument named in ``per_tick`` (the trainer's ``batch`` dict, made anew
every step), is a per-tick input: the graph owns a copy, which each call
overwrites.  Any other tensor inside a container argument (the weights'
and caches' dicts: weights, page pools, scales, rings, recurrent state;
the trainer's parameters and ``AdamWState``'s moments and int32 step) is
persistent: the graph reads and writes it where it was at capture.
Every call checks those addresses; a moved tensor (a restored
checkpoint's) gets a new capture of the key (counted in
``recaptures``), so a replay never runs over memory that has moved.

**Outputs are the graph's own buffers** (an output that is a persistent
input, as the caches or the parameters a step returns, is that input):
a replay overwrites the previous replay's.  Invariant of the callers:
each reads a graph's outputs before it replays that graph again (the
serving engine's ``emit`` before the next ``dispatch``, ``_draft_propose``
and ``_spec_tick`` copying theirs to the host at once; the trainer's
``float(metrics["loss"])`` after every step).

**Counts.**  A replay calls no kernel wrapper, so the capture records
what the wrappers counted while it ran (every ``launches``, the
autograd Functions' ``launches`` among them, the ``Counter`` tallies such
as ``by_tile``, ``last_kernel``, and the counters of
:data:`EXTRA_TALLIES`), takes it back (a capture launches nothing) and
adds it again at every replay: the counters read as if the step had run
eagerly.

**Autograd under capture.**  The backward of a captured
``torch.autograd.grad`` runs on autograd's device thread, on the stream
of the forward it differentiates, which is the capturing stream: its
kernels join the graph, and its allocations land in the graph's pool
(the caching allocator routes every allocation made on a stream that
this capture is capturing, whichever thread makes it, into the pool:
``chip_smoke.py`` phase 35 checks that a train step's capture reserves
nothing in the default pool).  ``capture_error_mode="thread_local"``
only keeps other threads' unsafe calls from invalidating the capture.
A leaf whose AccumulateGrad node an eager graph still alive made on
another stream cannot be differentiated inside the capture (CUDA
invalidates it); the trainer's parameters are first used by the
warm-up, on the capture stream.

**Lifetime.**  The graphs, their pools and their streams belong to the
:class:`CompiledStep` (held by the engine, the tuning variant or the
trainer that made it) and die with it; nothing at module level keeps
them.
"""
from __future__ import annotations

import collections
import gc
import inspect
from dataclasses import dataclass
from typing import Any, Callable

import torch

from .. import at
from ..kernels import autograd as ag
from ..kernels import flash_attention as fa
from ..kernels import matmul as mmk
from ..kernels import paged_attention as pa
from ..kernels import ssm_scan as k9

__all__ = ["CompiledStep", "CudaGraphs", "EXTRA_TALLIES", "TUNED_KERNELS",
           "compile_step", "graph_stats"]

#: the kernels whose published parameters (``at.tuned``) a step may read
TUNED_KERNELS = ("flash_attention", "chunked_attention", "flash_decode",
                 "flash_paged_decode", "flash_paged_prefill",
                 "flash_paged_verify", "matmul", "ssm_scan")

#: ``Counter`` tallies kept outside the kernels (a wrapper that counts
#: the calls of a kernel wrapper, or of a model's step); while one is in
#: this list a replay adds to it what its capture counted
EXTRA_TALLIES: list[collections.Counter] = []


def _kernels() -> tuple:
    return (*fa.KERNELS, *pa.KERNELS, *mmk.KERNELS, *k9.KERNELS,
            *ag.FUNCTIONS)


def _snapshot() -> list:
    """The counters' values: (holder, attribute, int) for the kernels'
    ``launches``, (Counter, None, copy) for their Counter tallies and
    (Counter, "extra", copy) for those of :data:`EXTRA_TALLIES`."""
    snap = []
    for k in _kernels():
        snap.append((k, "launches", k.launches))
        for c in vars(k).values():
            if isinstance(c, collections.Counter):
                snap.append((c, None, collections.Counter(c)))
    snap.extend((c, "extra", collections.Counter(c)) for c in EXTRA_TALLIES)
    return snap


def _restore(snap: list) -> None:
    for holder, attr, value in snap:
        if attr == "extra":
            attr = None
        if attr is None:
            holder.clear()
            holder.update(value)
        else:
            setattr(holder, attr, value)


def _delta(before: list) -> list:
    """What the counters gained since ``before``: (holder, attribute,
    gain) and, for a kernel that launched, (kernel, "last_kernel",
    value)."""
    out = []
    for holder, attr, value in before:
        if attr in (None, "extra"):
            gain = holder - value
            if gain:
                out.append((holder, attr, gain))
        elif getattr(holder, attr) != value:
            out.append((holder, attr, getattr(holder, attr) - value))
            if hasattr(holder, "last_kernel"):
                out.append((holder, "last_kernel", holder.last_kernel))
    return out


def _add(delta: list) -> None:
    """Add a capture's gains; a tally gone from :data:`EXTRA_TALLIES`
    (its counting block has ended) gets nothing."""
    for holder, attr, gain in delta:
        if attr == "extra":
            if any(holder is c for c in EXTRA_TALLIES):
                holder.update(gain)
        elif attr is None:
            holder.update(gain)
        elif attr == "last_kernel":
            holder.last_kernel = gain
        else:
            setattr(holder, attr, getattr(holder, attr) + gain)


def _spec(x: Any, top: bool, per_tick: list, persistent: list,
          deep: bool = False):
    """The hashable structure of ``x`` for the key, collecting its
    tensors: ``top`` (an argument itself) ones and every one under a
    ``deep`` (per-tick) argument as per-tick inputs, the rest as
    persistent."""
    if isinstance(x, torch.Tensor):
        tick = top or deep
        (per_tick if tick else persistent).append(x)
        return (tuple(x.shape), x.stride(), x.dtype, x.device, tick)
    if isinstance(x, dict):
        return ("dict",) + tuple(
            (k, _spec(v, False, per_tick, persistent, deep))
            for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(
            _spec(v, False, per_tick, persistent, deep) for v in x)
    hash(x)          # a non-tensor argument must be hashable
    return x


def _tuned_state() -> tuple:
    return (tuple(tuple(sorted(at.tuned(k).items())) for k in TUNED_KERNELS),
            fa._FORCED_WIDTH.get())


def _put(x: Any, deep: bool, it):
    """``x`` with its per-tick tensors (itself if a tensor, every tensor
    under it if ``deep``) replaced, in :func:`_spec`'s order, from
    ``it``."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if not deep:
        return x
    if isinstance(x, dict):
        return {k: _put(v, True, it) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        vals = [_put(v, True, it) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


class CudaGraphs:
    """The capture seam: how a step is warmed up, captured and replayed
    on a device (the tests put a stand-in here to drive the bookkeeping
    on the CPU)."""

    def takes(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def stream(self, device: torch.device):
        return torch.cuda.Stream(device)

    def warm_up(self, call: Callable, stream, device: torch.device):
        """``call()`` on ``stream``, ordered after the current stream's
        work and before its later work."""
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = call()
        current.wait_stream(stream)
        return out

    def capture(self, call: Callable, stream, device: torch.device):
        """(graph, outputs) of ``call`` captured on ``stream`` into a
        graph with a pool of its own."""
        graph = torch.cuda.CUDAGraph()
        # the warm-up's temporaries stay cached in the default pool, which
        # the graph's pool cannot take: released first, so a train step's
        # activations are not held twice
        torch.cuda.empty_cache()
        # no cycle collection while capturing: it may free a finished
        # engine's graphs, and destroying a graph is not permitted while
        # a stream of this thread captures (the capture is invalidated)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                out = call()
        finally:
            if collecting:
                gc.enable()
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()


@dataclass
class _Graph:
    graph: Any
    inputs: list             # the graph's per-tick input buffers
    addrs: tuple             # the persistent tensors' addresses
    out: Any                 # the graph's outputs
    counts: list             # what a replay adds to the counters
    keep: list               # the arrival-counter workspaces it reads


class CompiledStep:
    """``fn`` captured once per key and replayed (module docstring).
    ``captures``, ``replays`` and ``recaptures`` count this step's;
    ``graphs`` holds its graphs by key; ``fn`` is the eager step."""

    def __init__(self, fn: Callable, name: str,
                 backend: CudaGraphs | None = None, per_tick: tuple = ()):
        self.fn = fn
        self.name = name
        self.backend = backend or CudaGraphs()
        names = list(inspect.signature(fn).parameters) if per_tick else []
        #: the per-tick container arguments, by position and by keyword
        self._deep = {*per_tick, *(names.index(n) for n in per_tick)}
        self.graphs: dict[tuple, _Graph] = {}
        self.captures = self.replays = self.recaptures = 0
        self._streams: dict[torch.device, Any] = {}

    def __call__(self, *args, **kwargs):
        per_tick: list = []
        persistent: list = []
        spec = (tuple(_spec(a, True, per_tick, persistent, i in self._deep)
                      for i, a in enumerate(args)),
                tuple((k, _spec(v, True, per_tick, persistent,
                                k in self._deep))
                      for k, v in kwargs.items()))
        tensors = per_tick or persistent
        if not tensors or not self.backend.takes(tensors[0].device):
            return self.fn(*args, **kwargs)
        key = (spec, _tuned_state())
        addrs = tuple(t.data_ptr() for t in persistent)
        entry = self.graphs.get(key)
        if entry is not None and entry.addrs != addrs:
            del self.graphs[key]         # frees its pool before the new one
            self.recaptures += 1
            entry = None
        if entry is None:
            return self._capture(key, addrs, per_tick, tensors[0].device,
                                 args, kwargs)
        for buf, x in zip(entry.inputs, per_tick):
            buf.copy_(x)
        self.backend.replay(entry.graph)
        _add(entry.counts)
        self.replays += 1
        return entry.out

    def _capture(self, key, addrs, per_tick, device, args, kwargs):
        stream = self._streams.get(device)
        if stream is None:
            stream = self._streams[device] = self.backend.stream(device)
        out = self.backend.warm_up(lambda: self.fn(*args, **kwargs), stream,
                                   device)
        inputs = [x.clone() for x in per_tick]
        it = iter(inputs)
        s_args = tuple(_put(a, i in self._deep, it)
                       for i, a in enumerate(args))
        s_kwargs = {k: _put(v, k in self._deep, it)
                    for k, v in kwargs.items()}
        before = _snapshot()
        try:
            graph, g_out = self.backend.capture(
                lambda: self.fn(*s_args, **s_kwargs), stream, device)
        except Exception as err:
            raise RuntimeError(
                f"capturing the step {self.name!r} as a CUDA graph failed: "
                f"{err}") from err
        finally:
            counts = _delta(before)
            _restore(before)
        self.graphs[key] = _Graph(graph, inputs, addrs, g_out, counts,
                                  keep=pa.arrival_counters())
        self.captures += 1
        return out


def compile_step(fn: Callable, name: str | None = None,
                 backend: CudaGraphs | None = None,
                 per_tick: tuple = ()) -> CompiledStep:
    """``fn`` as a :class:`CompiledStep` named ``name`` (its
    ``__name__`` when not given).  ``per_tick``: the names of ``fn``'s
    arguments whose tensors, at any depth, are per-tick inputs (module
    docstring)."""
    return CompiledStep(fn, name or getattr(fn, "__name__", "step"), backend,
                        per_tick)


def graph_stats(steps) -> dict:
    """The captures, replays, recaptures and graphs of the
    :class:`CompiledStep` among ``steps`` (others are skipped), in all
    and by step name."""
    steps = [s for s in steps if isinstance(s, CompiledStep)]
    by_name: dict[str, int] = collections.Counter()
    for s in steps:
        if s.graphs:
            by_name[s.name] += len(s.graphs)
    return {"captures": sum(s.captures for s in steps),
            "replays": sum(s.replays for s in steps),
            "recaptures": sum(s.recaptures for s in steps),
            "graphs": dict(by_name)}
