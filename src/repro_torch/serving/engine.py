"""Serving engine: continuous batching over fixed decode lanes, with
time-slice preemption, on the dense KV lanes or the paged KV pool.

The engine wires the scheduler (FIFO admission + preemption), a KV
backend (:mod:`.kvcache`), the sampler and the metrics layer to the
model's steps, as the JAX package's engine does:

* admission runs one monolithic prefill per request (kernel K1 on the
  card) and copies its K/V into the lane's strip or pages; with
  ``prefill_chunk`` (paged only) a request is admitted with no compute
  and streams its prompt in chunk by chunk, one chunk per tick (kernel
  K4), so a long prompt never stalls the lanes that are decoding;
* every tick runs one batched decode step over all lanes (K2 on dense
  lanes, K3 on pages, K5 with ``num_splits``, K6 on int8 pages), idle
  lanes riding along at position 0 and mid-prefill lanes with their
  table rows masked to the null page;
* under page pressure an admission waits at the head of the queue and a
  lane that cannot grow is preempted: its pages swap out to the host and
  it resumes first, by swap-in, where it stopped (mid-prefill too);
* each tick splits into ``schedule`` / ``dispatch`` / ``emit``:
  ``dispatch`` only launches device work and records a CUDA event
  (:class:`TickWork`), ``emit`` is the first host-device sync.

Greedy output is token-for-token the JAX engine's on the same weights
and requests, int8 pages included.  ``num_splits`` stands in for the
JAX package's ``at.publish("flash_paged_decode", num_splits=...)`` until
the tuning layer is ported: it is handed to every paged decode step.
Speculative decoding, prefix caching, run-time tuning and meshes belong
to later slices (ROADMAP queue 1) and raise here.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import sampling
from .buckets import LENGTH_BUCKETS
from .kvcache import make_kv_cache
from .metrics import ServingMetrics
from .scheduler import LaneState, Request, Scheduler

__all__ = ["ServingEngine", "Request", "LaneState", "TickWork",
           "length_bucket"]

_NOT_PORTED = {
    "autotuner": "run-time tuning (ROADMAP queue 1, item 11)",
    "spec_k": "speculative decoding (ROADMAP queue 1, item 5)",
    "prefix_cache": "prefix caching (ROADMAP queue 1, item 5)",
    "mesh": "tensor-parallel serving (ROADMAP queue 1, item 10)",
}


def length_bucket(n: int, buckets=LENGTH_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class TickWork:
    """One dispatched decode tick whose logits are not on the host yet.

    ``logits`` is the (n_lanes, V) device tensor of the batched decode
    step; ``event`` is recorded on the current CUDA stream after the
    tick's launches (None on the CPU, where the work is already done).
    """

    logits: torch.Tensor
    decoding: list[int]        # lane ids in this tick's decode batch
    reqs: list[Request]        # the lanes' requests, same order
    event: torch.cuda.Event | None = None

    def block(self) -> None:
        """Wait for the tick's device work (callable off-thread)."""
        if self.event is not None:
            self.event.synchronize()


class ServingEngine:
    def __init__(self, model, params: dict, n_lanes: int = 4,
                 max_len: int = 512, eos_id: int | None = None,
                 cache: str = "dense", n_pages: int | None = None,
                 page_size: int = 16, timeslice: int | None = None,
                 autotuner=None, prefill_chunk: int | None = None,
                 spec_k: int | None = None, prefix_cache: bool = False,
                 kv_dtype: str = "fp", swap_compress: bool = False,
                 num_splits: int | None = None, mesh=None):
        for name, value in (("autotuner", autotuner),
                            ("spec_k", spec_k),
                            ("prefix_cache", prefix_cache or None),
                            ("mesh", mesh)):
            if value is not None:
                raise NotImplementedError(
                    f"{name}: {_NOT_PORTED[name]} is not ported yet")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.eos_id = eos_id
        self.kv = make_kv_cache(model, cache, n_lanes, max_len, self.device,
                                n_pages=n_pages, page_size=page_size,
                                kv_dtype=kv_dtype,
                                swap_compress=swap_compress)
        if num_splits is not None and self.kv.kind != "paged":
            raise ValueError(
                "num_splits splits the paged decode's page walk; use "
                "cache='paged'")
        if prefill_chunk is not None and self.kv.kind != "paged":
            raise ValueError(
                "chunked prefill streams the prompt into the paged KV "
                "cache; use cache='paged' (dense keeps monolithic prefill)")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.prefill_chunk = prefill_chunk
        self._decode = (
            functools.partial(model.paged_decode_step, num_splits=num_splits)
            if self.kv.kind == "paged" else model.decode_step)
        self.scheduler = Scheduler(n_lanes, timeslice=timeslice)
        self.metrics = ServingMetrics()
        self.active: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.steps = 0
        self.prefill_chunks = 0          # chunk steps run (chunked prefill)

    # -- admission ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    def _finish(self, lane_id: int, req: Request, now: float) -> None:
        req.done = True
        req.finish_t = now
        self.finished.append(req)
        self.metrics.observe(req)
        self.active.pop(req.rid, None)
        self.kv.release(lane_id)
        self.scheduler.vacate(lane_id)

    def _is_eos(self, tok: int) -> bool:
        """``eos_id=0`` is a valid stop token; ``None`` disables EOS."""
        return self.eos_id is not None and tok == self.eos_id

    def _next_token(self, req: Request, logits: torch.Tensor) -> int:
        """The request's next token from one logits row, keyed by its
        emission index (greedy = exact argmax)."""
        return sampling.sample_token(logits.cpu().numpy(), req.sampling,
                                     len(req.out_tokens))

    def _preempt_lane(self, lane_id: int, priority: bool = False) -> None:
        lane = self.scheduler.lanes[lane_id]
        req = self.active.pop(lane.rid)
        handle = self.kv.swap_out(lane_id)
        self.scheduler.preempt(lane_id, req, handle, priority=priority)

    def _admit(self) -> None:
        for lane_id in self.scheduler.free_lanes():
            nxt = self.scheduler.next_admission()
            if nxt is None:
                return
            kind, item = nxt
            if kind == "resume":
                if not self.kv.swap_in(lane_id, item.handle):
                    self.scheduler.push_back(kind, item)
                    return                 # no pages yet; retry next tick
                self.scheduler.occupy(lane_id, item.req, item.pos,
                                      item.remaining, phase=item.phase)
                self.active[item.req.rid] = item.req
                continue
            req = item
            if self.prefill_chunk is not None:
                # chunked admission: the lane enters its prefill phase with
                # no compute; the prefill tick streams the prompt in.  Gate
                # on pages for the first chunk only.
                if not self.kv.can_admit(min(self.prefill_chunk,
                                             len(req.prompt))):
                    self.scheduler.push_back(kind, req)
                    return                 # page pressure; stay queued
                if req.admit_t is None:
                    req.admit_t = time.monotonic()   # queue wait ends here
                self.scheduler.occupy(lane_id, req, 0, req.max_new_tokens,
                                      phase="prefill")
                self.active[req.rid] = req
                continue
            if self.kv.kind == "paged" and not self.kv.can_admit(
                    len(req.prompt)):
                self.scheduler.push_back(kind, req)
                return                     # page pressure; stay queued
            if req.admit_t is None:
                req.admit_t = time.monotonic()   # queue wait ends here
            tokens = torch.tensor([req.prompt], dtype=torch.long,
                                  device=self.device)
            logits, cache1 = self.model.prefill(
                self.params, tokens, self.kv.prefill_len(len(req.prompt)))
            if not self.kv.admit(lane_id, cache1, len(req.prompt)):
                self.scheduler.push_back(kind, req)
                return
            tok = self._next_token(req, logits[0])
            now = time.monotonic()
            req.out_tokens.append(tok)
            req.first_token_t = now
            req.token_ts.append(now)
            self.scheduler.occupy(lane_id, req, len(req.prompt),
                                  req.max_new_tokens - 1)
            self.active[req.rid] = req
            if req.max_new_tokens <= 1 or self._is_eos(tok):
                self._finish(lane_id, req, now)

    def _prefill_tick(self) -> None:
        """One prefill chunk for every mid-prefill lane.

        Each lane streams ``prefill_chunk`` prompt tokens into its pages
        per tick (pages allocated chunk by chunk, the ragged last chunk
        padded into the null page).  The final chunk's last valid row
        gives the request's first token (TTFT stamps here).  A lane that
        cannot get the chunk's pages is preempted mid-prefill and resumes
        where it stopped."""
        if self.prefill_chunk is None:
            return
        c = self.prefill_chunk
        for lane_id in self.scheduler.prefill_lanes():
            lane = self.scheduler.lanes[lane_id]
            req = self.active[lane.rid]
            plen = len(req.prompt)
            start, end = lane.pos, min(lane.pos + c, plen)
            if not self.kv.ensure_tokens(lane_id, end):
                if len(self.active) == 1:
                    raise RuntimeError(
                        f"page pool too small: sequence {lane.rid} needs "
                        f"pages for prompt positions [{start}, {end}) and "
                        "no other lane can be evicted")
                self._preempt_lane(lane_id, priority=True)
                continue
            chunk = req.prompt[start:end] + [0] * (c - (end - start))
            logits, _ = self.model.paged_prefill_step(
                self.params, self.kv.caches, self.kv.table_row(lane_id),
                torch.tensor([chunk], dtype=torch.long, device=self.device),
                torch.tensor([start], device=self.device),
                torch.tensor([end], device=self.device),
                torch.tensor([end - start - 1], device=self.device))
            self.prefill_chunks += 1
            lane.pos = end
            if end < plen:
                continue                   # prompt still streaming in
            tok = self._next_token(req, logits[0])
            now = time.monotonic()
            req.out_tokens.append(tok)
            req.first_token_t = now
            req.token_ts.append(now)
            lane.phase = "decode"
            lane.remaining = req.max_new_tokens - 1
            if req.max_new_tokens <= 1 or self._is_eos(tok):
                self._finish(lane_id, req, now)

    def _ensure_capacity(self) -> None:
        """Every decoding lane must own the page its next token writes to
        (a dense strip always has room below ``max_len``: the emit step
        retires a lane at ``max_len - 1``).  A lane whose page cannot be
        allocated is preempted, its pages swapped out to make room for
        the rest; mid-prefill lanes allocate in the prefill tick."""
        for lane_id in self.scheduler.decode_lanes():
            lane = self.scheduler.lanes[lane_id]
            if self.kv.ensure_capacity(lane_id, lane.pos):
                continue
            if self.kv.kind != "paged":
                raise RuntimeError(
                    f"lane {lane_id} at pos {lane.pos} is past max_len "
                    f"{self.max_len}")
            if len(self.active) == 1:
                raise RuntimeError(
                    f"page pool too small: sequence {lane.rid} needs "
                    f"another page at pos {lane.pos} and no other lane "
                    "can be evicted")
            self._preempt_lane(lane_id, priority=True)

    # -- one scheduler tick: schedule -> dispatch -> emit --------------------
    def schedule(self) -> None:
        """Host-side half of a tick: time-slice victim, admissions (each
        monolithic prefill runs here), then one prefill chunk per
        mid-prefill lane."""
        victim = self.scheduler.pick_victim()
        if victim is not None:
            self._preempt_lane(victim)
        self._admit()
        self._prefill_tick()

    def dispatch(self) -> TickWork | None:
        """Launch the tick's batched decode step without waiting on it.
        The caches are updated in place by the step; the logits stay on
        the device inside the returned :class:`TickWork` until
        :meth:`emit`.  None when no lane is decoding."""
        self._ensure_capacity()
        decoding = self.scheduler.decode_lanes()
        if not decoding:
            return None
        token = np.zeros((self.n_lanes, 1), np.int64)
        pos = np.zeros((self.n_lanes,), np.int64)
        for i in decoding:
            lane = self.scheduler.lanes[i]
            token[i, 0] = self.active[lane.rid].out_tokens[-1]
            pos[i] = lane.pos
        # mid-prefill lanes ride along in the batched step with a zeroed
        # page-table row: their dummy K/V write lands in the null page
        extra = self.kv.decode_extra(
            mask_lanes=self.scheduler.prefill_lanes())
        logits, _ = self._decode(
            self.params, self.kv.caches, *extra,
            torch.from_numpy(token).to(self.device),
            torch.from_numpy(pos).to(self.device))
        event = None
        if logits.is_cuda:
            event = torch.cuda.Event()
            event.record()
        reqs = [self.active[self.scheduler.lanes[i].rid] for i in decoding]
        return TickWork(logits=logits, decoding=decoding, reqs=reqs,
                        event=event)

    def emit(self, work: TickWork | None) -> None:
        """Copy a dispatched tick's logits to the host (the tick's first
        sync), sample each lane's token, and run the finish bookkeeping.
        No-op for ``None``."""
        if work is None:
            return
        logits_np = work.logits.cpu().numpy()
        toks = sampling.sample_batch(
            logits_np[work.decoding], [r.sampling for r in work.reqs],
            [len(r.out_tokens) for r in work.reqs])
        now = time.monotonic()
        self.steps += 1
        for i, req, tok in zip(work.decoding, work.reqs, toks):
            lane = self.scheduler.lanes[i]
            req.out_tokens.append(tok)
            req.token_ts.append(now)
            lane.pos += 1
            lane.remaining -= 1
            lane.steps_served += 1
            lane.tokens_served += 1
            if lane.remaining <= 0 or self._is_eos(tok) \
                    or lane.pos >= self.max_len - 1:
                self._finish(i, req, now)

    def step(self) -> None:
        self.schedule()
        self.emit(self.dispatch())

    def run(self, max_steps: int = 1000) -> list[Request]:
        while (self.scheduler.has_queued or self.active) \
                and self.steps < max_steps:
            steps_before, done_before = self.steps, len(self.finished)
            self.step()
            if not self.active and self.scheduler.has_queued \
                    and self.steps == steps_before \
                    and len(self.finished) == done_before:
                raise RuntimeError(
                    "admission stalled: queued work cannot obtain a lane "
                    "or pages (page pool smaller than one sequence?)")
        return self.finished
