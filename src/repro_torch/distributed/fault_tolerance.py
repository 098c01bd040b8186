"""Fault tolerance: heartbeat failure detection, elastic re-mesh planning,
straggler mitigation (the JAX package's ``distributed/fault_tolerance.py``,
which imports no JAX; the port keeps its own copy).

* :class:`HeartbeatMonitor` — hosts report heartbeats; a host silent for
  ``timeout_s`` is declared failed.
* :func:`plan_remesh` — given the surviving chip count, choose the largest
  spare-free mesh (keeping the model axis intact, shrinking the data/pod
  axes), and emit the resharding plan: restore from the latest checkpoint
  with new shardings + rescale ``global_batch`` or grad-accum.
* :class:`StragglerWatchdog` — per-step wall-time EMA + z-score detector;
  persistent stragglers trigger the same remesh path (eject the slow
  host).  The observable is step_time(host) fed by the launcher.

Recovery sequence (``launch/train.py`` drives the detection):
  detect -> checkpoint-wait -> plan_remesh -> rebuild mesh ->
  restore(ckpt, new shardings) -> resume data at (step, new shard map).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


@dataclass
class HeartbeatMonitor:
    n_hosts: int
    timeout_s: float = 30.0
    last_seen: dict[int, float] = field(default_factory=dict)
    failed: set[int] = field(default_factory=set)

    def beat(self, host: int, now: float | None = None) -> None:
        self.last_seen[host] = time.monotonic() if now is None else now

    def tick(self, now: float | None = None) -> set[int]:
        """Returns newly-failed hosts."""
        now = time.monotonic() if now is None else now
        new = set()
        for h in range(self.n_hosts):
            if h in self.failed:
                continue
            seen = self.last_seen.get(h)
            if seen is None or now - seen > self.timeout_s:
                self.failed.add(h)
                new.add(h)
        return new

    @property
    def alive(self) -> list[int]:
        return [h for h in range(self.n_hosts) if h not in self.failed]


@dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple
    new_shape: tuple
    axis_names: tuple
    batch_scale: float       # new_global_batch / old
    resume_step: int
    note: str


def plan_remesh(old_shape: tuple, axis_names: tuple, surviving_chips: int,
                resume_step: int, model_axis: str = "model") -> RemeshPlan:
    """Largest spare-free mesh that keeps the model axis intact.

    The model axis carries sharded weights (resharding it is a full
    re-layout); the data/pod axes are pure DP and shrink freely.  The
    surviving chip count is rounded down to a multiple of the model axis,
    then the data axis takes the quotient (pod axis folds into data when a
    whole pod is lost).
    """
    sizes = dict(zip(axis_names, old_shape))
    m = sizes.get(model_axis, 1)
    usable = (surviving_chips // m) * m
    if usable < m:
        raise RuntimeError(
            f"cannot keep model axis of {m} with {surviving_chips} chips")
    data_total = usable // m
    old_data_total = math.prod(s for a, s in sizes.items()
                               if a != model_axis)
    if "pod" in sizes and data_total % sizes["pod"] == 0 \
            and data_total >= sizes["pod"]:
        new_shape = (sizes["pod"], data_total // sizes["pod"], m)
        names = ("pod", "data", model_axis)
        note = "kept pod axis"
    else:
        new_shape = (data_total, m)
        names = ("data", model_axis)
        note = "folded pod axis into data"
    return RemeshPlan(old_shape=tuple(old_shape), new_shape=new_shape,
                      axis_names=names,
                      batch_scale=data_total / old_data_total,
                      resume_step=resume_step, note=note)


@dataclass
class StragglerWatchdog:
    """Per-host step-time EMA + z-score detection."""

    n_hosts: int
    alpha: float = 0.1
    z_threshold: float = 3.0
    strikes_to_eject: int = 3
    ema: dict[int, float] = field(default_factory=dict)
    var: dict[int, float] = field(default_factory=dict)
    strikes: dict[int, int] = field(default_factory=dict)

    def observe(self, host: int, step_time: float) -> bool:
        """Record one step time; returns True if host should be ejected."""
        mu = self.ema.get(host, step_time)
        var = self.var.get(host, 0.0)
        fleet = [self.ema[h] for h in self.ema if h != host]
        fleet_mu = sum(fleet) / len(fleet) if fleet else mu
        fleet_sd = (sum((x - fleet_mu) ** 2 for x in fleet)
                    / len(fleet)) ** 0.5 if len(fleet) > 1 else 0.0
        is_straggling = fleet_sd > 0 and \
            (step_time - fleet_mu) / fleet_sd > self.z_threshold
        self.ema[host] = (1 - self.alpha) * mu + self.alpha * step_time
        self.var[host] = (1 - self.alpha) * var \
            + self.alpha * (step_time - mu) ** 2
        if is_straggling:
            self.strikes[host] = self.strikes.get(host, 0) + 1
        else:
            self.strikes[host] = 0
        return self.strikes.get(host, 0) >= self.strikes_to_eject
