"""Request scheduling for the serving engine: FIFO admission + preemption.

A copy of the JAX package's scheduler (pure policy, stdlib only).  The
scheduler decides
*which* request gets a lane and *when* a running one is preempted; the
engine performs the actual model and cache operations.  One unified ``ready`` queue (``collections.deque``,
O(1) at both ends) holds new requests and preempted sequences in FIFO
order:

* new requests join at the back;
* a **time-slice** victim also joins at the back — it yields its lane to
  whatever is at the head of the queue, which is what makes preemption an
  actual rotation (the engine serves more concurrent requests than it has
  decode lanes) rather than an immediate self-re-admission;
* a **page-pressure** victim (evicted because the pool could not grow its
  sequence) re-joins at the *front*: it resumes as soon as pages free up,
  so memory eviction never turns into queue starvation.

Preempted sequences carry a KV swap handle and resume by swap-in — no
prefill re-run, bit-identical continuation.

With chunked prefill a lane passes through a **prefill phase** first
(``LaneState.phase``): ``pos`` counts committed prompt tokens until the
prompt is fully streamed in, then the lane flips to ``decode``.  A lane
preempted mid-prefill re-queues with its phase and progress in the
:class:`ResumeEntry`, so it resumes exactly where it stopped.  Time-slice
victim selection only considers decoding lanes (a prefill chunk is one
bounded unit of work per tick already); page-pressure eviction of a
prefill lane is handled by the engine's prefill tick.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from .sampling import SamplingParams


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    sampling: SamplingParams = field(default_factory=SamplingParams)
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False
    # timestamps use the monotonic clock (as does the engine): TTFT/ITL
    # are durations, and wall-clock adjustments (NTP slew, DST) must not
    # produce negative or inflated latency percentiles
    submit_t: float = field(default_factory=time.monotonic)
    admit_t: float | None = None   # first lane occupancy (queue wait ends)
    first_token_t: float | None = None
    finish_t: float | None = None
    token_ts: list[float] = field(default_factory=list)
    preemptions: int = 0
    cached_tokens: int = 0     # prompt tokens served from the prefix cache
    cancelled: bool = False    # aborted (client disconnect), not finished


@dataclass
class LaneState:
    rid: int | None = None
    pos: int = 0               # decode: next KV write position;
    #                            prefill: prompt tokens committed so far
    remaining: int = 0         # decode-token budget left
    steps_served: int = 0      # decode steps since (re-)admission
    tokens_served: int = 0     # tokens emitted since (re-)admission (a
    #                            speculative tick emits several per step)
    phase: str = "decode"      # "prefill" while the prompt streams in


@dataclass
class ResumeEntry:
    """A preempted request plus everything needed to resume it."""

    req: Request
    handle: Any                # kv backend swap handle
    pos: int
    remaining: int
    phase: str = "decode"      # preempted mid-prefill resumes mid-prefill


class Scheduler:
    """FIFO + preemptive continuous batching over ``n_lanes`` slots."""

    def __init__(self, n_lanes: int, timeslice: int | None = None):
        self.lanes = [LaneState() for _ in range(n_lanes)]
        self.ready: deque[Request | ResumeEntry] = deque()
        self.timeslice = timeslice
        self.preemptions = 0

    # -- queue state --------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.ready.append(req)

    @property
    def has_queued(self) -> bool:
        return bool(self.ready)

    @property
    def pending(self) -> int:
        return len(self.ready)

    @property
    def waiting(self) -> deque:
        """New (never-run) requests still queued, in FIFO order."""
        return deque(r for r in self.ready if isinstance(r, Request))

    def free_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self.lanes) if l.rid is None]

    def active_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self.lanes) if l.rid is not None]

    def prefill_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self.lanes)
                if l.rid is not None and l.phase == "prefill"]

    def decode_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self.lanes)
                if l.rid is not None and l.phase == "decode"]

    # -- admission ----------------------------------------------------------
    def next_admission(self) -> tuple[str, Any] | None:
        """Head of the ready queue as ('resume' | 'new', item)."""
        if not self.ready:
            return None
        item = self.ready.popleft()
        return ("resume" if isinstance(item, ResumeEntry) else "new", item)

    def push_back(self, kind: str, item: Any) -> None:
        """Return an un-admittable item to the head of the queue."""
        self.ready.appendleft(item)

    def remove_queued(self, rid: int) -> Request | None:
        """Pull a queued request (new or preempted) out of the ready deque
        — the cancellation path for work that never reached, or was bumped
        from, a lane.  Returns the request, or None if ``rid`` is not
        queued."""
        for item in self.ready:
            req = item.req if isinstance(item, ResumeEntry) else item
            if req.rid == rid:
                self.ready.remove(item)
                return req
        return None

    def occupy(self, lane_id: int, req: Request, pos: int,
               remaining: int, phase: str = "decode") -> None:
        self.lanes[lane_id] = LaneState(rid=req.rid, pos=pos,
                                        remaining=remaining, steps_served=0,
                                        phase=phase)

    def vacate(self, lane_id: int) -> None:
        self.lanes[lane_id] = LaneState()

    # -- preemption ---------------------------------------------------------
    def pick_victim(self) -> int | None:
        """Time-slice policy: with work queued, preempt the longest-served
        lane once it has used up its slice.  Service is counted in both
        decode steps and emitted tokens — a speculative tick emits several
        tokens per step, and the larger of the two counts is what burns
        the slice (variable tokens-per-tick can't stretch a lane's turn).
        Returns a lane id or None."""
        if self.timeslice is None or not self.has_queued:
            return None
        served = [(max(l.steps_served, l.tokens_served), i)
                  for i, l in enumerate(self.lanes)
                  if l.rid is not None and l.phase == "decode"
                  and max(l.steps_served, l.tokens_served) >= self.timeslice]
        if not served:
            return None
        return max(served)[1]

    def preempt(self, lane_id: int, req: Request, handle: Any,
                priority: bool = False) -> None:
        """Vacate ``lane_id``; the sequence re-queues at the back (time
        slice expired: yield to the queue head) or the front
        (``priority=True``, page pressure: resume as soon as possible)."""
        lane = self.lanes[lane_id]
        req.preemptions += 1
        self.preemptions += 1
        entry = ResumeEntry(req=req, handle=handle, pos=lane.pos,
                            remaining=lane.remaining, phase=lane.phase)
        if priority:
            self.ready.appendleft(entry)
        else:
            self.ready.append(entry)
        self.vacate(lane_id)
