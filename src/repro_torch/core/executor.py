"""Measurement backends for the AT search.

The paper measures wall-clock on the target machine.  Here four executors
share one interface — ``__call__(assignment) -> cost`` — so search.py is
agnostic to how cost is obtained:

* :class:`WallClockExecutor` — times a variant callable with the host
  clock; before the clock stops it synchronises the device of every CUDA
  tensor in the variant's result, so a CUDA variant is timed to its
  completion, not to its launch (warmup run excluded).
* :class:`CudaEventExecutor` — device time of a CUDA variant from CUDA
  events recorded around each launch (warm-up launches excluded), all
  queued behind a spin of the device so that the host's launch overhead
  is not in the intervals; used by install-time AT on the card
  (``tuning/install.py``).
* :class:`CostModelExecutor` — evaluates an analytic cost (``according
  estimated`` / the roofline model) without executing anything.  Used by the
  static tuner against compiled dry-run artifacts.
* :class:`TableExecutor` — replays a {assignment-key: cost} table (tests,
  and the paper-count benchmarks where only the trajectory matters).

``CountingExecutor`` wraps any of them to assert evaluation counts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from .cost import eval_expr
from .errors import OATSpecError


def _cuda_devices(x: Any, found: set) -> set:
    """The devices of every CUDA tensor in ``x`` (nested lists, tuples and
    dict values)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    return found


def _block(x: Any) -> None:
    """Wait until ``x`` is computed: synchronise the device of every CUDA
    tensor in it.  A fault of the variant surfaces here and propagates."""
    for device in _cuda_devices(x, set()):
        torch.cuda.synchronize(device)


@dataclass
class WallClockExecutor:
    """cost = min wall-clock seconds over ``repeats`` runs of the variant.

    ``make_variant(assignment)`` returns a zero-arg callable; its result is
    blocked on (CUDA launches are asynchronous) before the clock stops.
    """

    make_variant: Callable[[dict], Callable[[], Any]]
    repeats: int = 3
    warmup: int = 1

    def __call__(self, assignment: dict[str, Any]) -> float:
        fn = self.make_variant(assignment)
        for _ in range(self.warmup):
            _block(fn())
        best = float("inf")
        for _ in range(self.repeats):
            t0 = time.perf_counter()
            _block(fn())
            best = min(best, time.perf_counter() - t0)
        return best


@dataclass
class CudaEventExecutor:
    """cost = least device seconds of one run of a CUDA variant over
    ``repeats`` runs, each between two CUDA events recorded on the current
    stream; the ``warmup`` runs before them are not timed.  The timed runs
    are enqueued behind a spin of ``SPIN_CYCLES`` device clocks, so
    each start event fires when the previous run ends, not while the host
    is still in the variant's wrapper: on an idle device the interval of
    a short kernel would hold its launch overhead too.

    ``make_variant(assignment)`` returns a zero-arg callable that launches
    work on ``device``'s current stream.  Errors of a launch propagate.
    """

    make_variant: Callable[[dict], Callable[[], Any]]
    repeats: int = 10
    warmup: int = 2
    device: Any = "cuda"
    #: ~10 ms on an H100, longer than the host takes to enqueue the runs
    SPIN_CYCLES = 20_000_000

    def __call__(self, assignment: dict[str, Any]) -> float:
        fn = self.make_variant(assignment)
        with torch.cuda.device(self.device):
            for _ in range(self.warmup):
                fn()
            torch.cuda.synchronize()
            marks = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                     for _ in range(max(1, self.repeats))]
            torch.cuda._sleep(self.SPIN_CYCLES)
            for start, end in marks:
                start.record()
                fn()
                end.record()
            torch.cuda.synchronize()
        return min(s.elapsed_time(e) for s, e in marks) / 1e3


@dataclass
class CostModelExecutor:
    """cost = analytic expression/callable over (assignment + env)."""

    cost: str | Callable[[dict], float]
    env: dict[str, Any] = field(default_factory=dict)

    def __call__(self, assignment: dict[str, Any]) -> float:
        ns = dict(self.env)
        ns.update(assignment)
        if callable(self.cost):
            return float(self.cost(ns))
        return float(eval_expr(self.cost, ns))


@dataclass
class TableExecutor:
    """cost looked up from a table keyed by sorted assignment items."""

    table: dict[tuple, float]
    default: float | None = None

    @staticmethod
    def key(assignment: dict[str, Any]) -> tuple:
        return tuple(sorted(assignment.items()))

    def __call__(self, assignment: dict[str, Any]) -> float:
        k = self.key(assignment)
        if k in self.table:
            return self.table[k]
        if self.default is not None:
            return self.default
        raise OATSpecError(f"no cost recorded for assignment {assignment}")


class CountingExecutor:
    """Wraps an executor and counts calls (paper-count assertions)."""

    def __init__(self, inner: Callable[[dict], float]):
        self.inner = inner
        self.count = 0
        self.trajectory: list[dict] = []

    def __call__(self, assignment: dict[str, Any]) -> float:
        self.count += 1
        self.trajectory.append(dict(assignment))
        return self.inner(assignment)
