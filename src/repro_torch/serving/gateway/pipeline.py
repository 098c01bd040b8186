"""Pipelined async tick loop: host scheduling overlaps device compute.

The synchronous ``ServingEngine.run()`` loop serialises everything: the
host waits for every tick's logits before it looks at the admission
queue again.  :class:`PipelinedEngine` drives the same engine through its
split tick phases (``schedule`` / ``dispatch`` / ``emit``) inside an
asyncio loop instead:

1. **schedule** — victim selection, admissions, prefill chunks (host work
   plus kernel launches);
2. **dispatch** — the batched decode step's kernels are launched on the
   current CUDA stream, the caches are written in place, and a CUDA event
   is recorded behind them (:class:`~repro_torch.serving.engine.TickWork`);
3. between dispatch and emit the tick's device work may still be running
   and the host is free: the next tick's arrivals drain into the
   scheduler queue and — because the wait on the event happens in a
   worker thread (``run_in_executor(None, work.block)``, which releases
   the interpreter lock inside ``cudaEventSynchronize``) — the asyncio
   loop keeps serving HTTP handlers and flushing SSE frames of tokens
   already emitted;
4. **emit** — the logits are copied to the host (the tick's first host
   sync in the engine), tokens are sampled and pushed into the
   per-request :class:`TokenStream` queues.

With ``max_inflight=1`` the loop does not await the event: emit's copy
waits for the device inline (the synchronous engine with a network
front-end).  With ``max_inflight=2`` the double-buffered path above runs.
Either way the model compute per request is the same, so greedy outputs
are identical to ``ServingEngine.run()``: the pipeline moves host work
around, never device math.  In eager PyTorch, dispatch launches each
kernel from the loop's thread, so most of a tick's host time is spent
before the event is recorded; what the overlap can hide is what is left
of the device's work at that point.

Cancellation discipline: client disconnects mark the request in
``_pending_cancel`` and the loop applies them only at the top of a tick,
never between dispatch and emit (the in-flight tick still writes the
lane's pages).  ``ServingEngine.cancel_request`` then releases the lane
and its pages and refcounts, so the pool's three-state accounting stays
exact.

The concurrency knobs — pipeline depth x admission batch
(:class:`GatewayPolicyKnobs`) — are fixed, or chosen by run-time AT: with
a ``tuner`` that declares the ``GatewayPolicy`` region
(``DecodeAutoTuner.add_gateway``), the loop runs windows of
``policy_window`` finished requests under each candidate's knobs, reports
each window's goodput statistics through the region, and applies the
committed winner (at once, with no window, when the workdir already holds
it), as the JAX package's gateway does.  ``stats()`` also reports the loop's host time by phase: the ms
spent in schedule + dispatch, the ms from the await on the tick's event
to its return, and the ms in emit (with ``max_inflight=1`` the wait is
inside emit).

Over a serving mesh of more than one rank (``mesh``, every rank one
engine of a tensor-parallel world) rank 0 alone owns the gateway: its
server, its clients, its queue and its policy.  Before each tick's
schedule it broadcasts the tick's inputs (``collectives.broadcast_object``):
the requests it moved into its engine and the cancellations it applied,
in the order it applied them.  Ranks 1.. run :meth:`follow` instead of
:meth:`run`: they apply the same inputs to their engines and step them
through the same ``schedule`` / ``dispatch`` / ``emit``, whose own
broadcasts (``ServingEngine._decide``) keep their tokens rank 0's.  A
``GatewayPolicy`` window's statistics go to every rank before its region
runs, so each rank's region takes rank 0's measurement and commits rank
0's winner.  An idle rank 0 sends an empty message every tenth of the
mesh's collective timeout (``Mesh.timeout_s``, the world's), so the
followers' waits never time out, and a stop message when it drains,
which ends the followers' loops.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass

from ...distributed.collectives import broadcast_object
from ..metrics import percentile
from ..scheduler import Request

__all__ = ["PipelinedEngine", "TokenStream", "GatewayPolicyKnobs",
           "QueueFull", "Draining", "meets_slo", "goodput_stats"]

_IDLE_SLEEP_S = 0.002          # the loop's poll period with nothing to do


class QueueFull(Exception):
    """Admission queue at capacity — the 429 + Retry-After path."""


class Draining(Exception):
    """Gateway is draining — no new admissions (the 503 path)."""


def meets_slo(req: Request, slo_ttft_s: float, slo_itl_s: float) -> bool:
    """Did this finished request meet its latency SLO?

    * TTFT (submit to first token, queueing included) <= ``slo_ttft_s``;
    * p95 inter-token latency <= ``slo_itl_s``.

    Unfinished/cancelled requests never meet the SLO.
    """
    if req.first_token_t is None or req.cancelled:
        return False
    if req.first_token_t - req.submit_t > slo_ttft_s:
        return False
    itls = [b - a for a, b in zip(req.token_ts, req.token_ts[1:])]
    if itls:
        p95 = percentile(itls, 95)
        if p95 is not None and p95 > slo_itl_s:
            return False
    return True


def goodput_stats(requests: list[Request], wall_s: float,
                  slo_ttft_s: float, slo_itl_s: float) -> dict:
    """SLO attainment + goodput over a set of finished requests.

    *Goodput* counts only the tokens of requests that met their SLO —
    tokens/s that arrived too late to matter are throughput, not service.
    """
    ok = [r for r in requests if meets_slo(r, slo_ttft_s, slo_itl_s)]
    good_tokens = sum(len(r.out_tokens) for r in ok)
    all_tokens = sum(len(r.out_tokens) for r in requests)
    return {
        "requests": len(requests),
        "slo_ok": len(ok),
        "slo_attainment": len(ok) / len(requests) if requests else 0.0,
        "good_tokens": good_tokens,
        "goodput_tok_s": good_tokens / wall_s if wall_s > 0 else 0.0,
        "tokens_per_s": all_tokens / wall_s if wall_s > 0 else 0.0,
        "time_per_good_token": (wall_s / good_tokens if good_tokens
                                else float("inf")),
        "slo_ttft_s": slo_ttft_s,
        "slo_itl_s": slo_itl_s,
    }


@dataclass
class GatewayPolicyKnobs:
    """The pipeline's concurrency knobs (the ``GatewayPolicy`` region's
    parameters)."""

    max_inflight: int = 2      # 1 = inline sync; 2 = double-buffered tick
    admit_batch: int = 4       # arrivals moved into the scheduler per tick


class TokenStream:
    """Per-request async token stream between the tick loop and one SSE
    handler.  The loop pushes ``("tokens", [ids])`` deltas and exactly one
    terminal ``("done", info)`` / ``("cancelled", info)`` event."""

    def __init__(self, req: Request):
        self.req = req
        self.queue: asyncio.Queue = asyncio.Queue()
        self.sent = 0              # out_tokens already pushed
        self.closed = False

    async def next_event(self):
        return await self.queue.get()

    def push(self, kind: str, payload) -> None:
        if not self.closed:
            self.queue.put_nowait((kind, payload))
            if kind in ("done", "cancelled"):
                self.closed = True


class PipelinedEngine:
    """Asyncio tick loop over a
    :class:`~repro_torch.serving.engine.ServingEngine`.

    One instance owns the engine exclusively while running: arrivals
    enter through :meth:`submit` (bounded; raises :class:`QueueFull` /
    :class:`Draining`), tokens leave through per-request
    :class:`TokenStream` queues, disconnects go through :meth:`cancel`.
    """

    def __init__(self, engine, *, queue_limit: int = 64,
                 knobs: GatewayPolicyKnobs | None = None, tuner=None,
                 policy_window: int = 4, slo_ttft_s: float = 2.0,
                 slo_itl_s: float = 0.5, mesh=None):
        self.engine = engine
        # a serving mesh of more than one rank: rank 0 leads, the others
        # follow its broadcast tick inputs
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        # the followers' heartbeat, well inside their collectives' timeout
        self.heartbeat_s = (self.mesh.timeout_s / 10 if self.mesh is not None
                            else None)
        self._ops: list[tuple] = []        # inputs the followers lack yet
        self._last_sync = time.monotonic()
        self.syncs = 0                     # messages sent or received
        self.queue_limit = queue_limit
        self.knobs = knobs or GatewayPolicyKnobs()
        self.tuner = tuner
        self.policy_window = max(1, policy_window)
        self.slo_ttft_s = slo_ttft_s
        self.slo_itl_s = slo_itl_s
        self.arrivals: deque[Request] = deque()
        self.streams: dict[int, TokenStream] = {}
        self._pending_cancel: set[int] = set()
        self._next_rid = 0
        self._draining = False
        self._stopped = False
        self._task: asyncio.Task | None = None
        self._loop_error: BaseException | None = None
        # counters
        self.ticks = 0
        self.overlapped_ticks = 0      # ticks whose wait ran off-loop
        self.rejected = 0              # QueueFull bounces (429s served)
        self.cancels = 0
        # the loop's host seconds by tick phase
        self.schedule_dispatch_s = 0.0
        self.wait_s = 0.0
        self.emit_s = 0.0
        # GatewayPolicy measurement windows
        self.policy_windows = 0
        self._window_t0: float | None = None
        self._window_reqs: list[Request] = []
        self._seen_finished = 0
        self._policy_applied = False
        self._apply_policy_candidate()

    # -- GatewayPolicy region plumbing ----------------------------------
    def _gateway_region_live(self) -> bool:
        return self.tuner is not None \
            and getattr(self.tuner, "gateway_region", None) is not None

    def _apply_policy_candidate(self) -> None:
        """Apply the knobs the region wants next: the committed winner
        (a warm start applies it at once and runs no window), else the
        next untried candidate, the index ``execute`` measures next, so a
        window's statistics go to the knobs that produced them."""
        if not self._gateway_region_live():
            self._policy_applied = True
            return
        idx = self.tuner.gateway_candidate()
        mi, ab = self.tuner.gateway_variants[idx]
        self.knobs = GatewayPolicyKnobs(max_inflight=mi, admit_batch=ab)
        self._policy_applied = self.tuner.committed_gateway() is not None

    def _policy_tick(self, now: float) -> None:
        """Close a measurement window once ``policy_window`` requests have
        finished under the current candidate's knobs, report its goodput
        statistics through the region, and move to the next candidate (or
        the committed winner)."""
        if self._policy_applied or not self._gateway_region_live():
            return
        fin = self.engine.finished
        if self._window_t0 is None:
            self._window_t0 = now
            self._seen_finished = len(fin)
            return
        new = fin[self._seen_finished:]
        if new:
            self._window_reqs.extend(new)
            self._seen_finished = len(fin)
        if len(self._window_reqs) < self.policy_window:
            return
        stats = goodput_stats(self._window_reqs, now - self._window_t0,
                              self.slo_ttft_s, self.slo_itl_s)
        self._sync(policy=stats)
        self._run_policy(stats)
        self._window_t0 = now
        self._window_reqs = []

    def _run_policy(self, stats: dict) -> None:
        """One measurement of the ``GatewayPolicy`` region, then the knobs
        it wants next (every rank, on rank 0's statistics)."""
        self.tuner.gateway_policy(stats)
        self.policy_windows += 1
        self._apply_policy_candidate()

    # -- submission / cancellation --------------------------------------
    @property
    def backlog(self) -> int:
        """Requests waiting for a lane (gateway queue + scheduler queue)."""
        return len(self.arrivals) + self.engine.scheduler.pending

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               sampling=None, submit_t: float | None = None) -> TokenStream:
        """Register one request.  ``submit_t`` should be the *arrival*
        timestamp (the HTTP handler stamps it before any queueing) so
        queue-wait percentiles include gateway-side delay."""
        if self._draining or self._stopped:
            raise Draining("gateway is draining")
        if self.backlog >= self.queue_limit:
            self.rejected += 1
            raise QueueFull(f"admission queue at capacity "
                            f"({self.queue_limit} waiting)")
        rid = self._next_rid
        self._next_rid += 1
        kwargs = {"submit_t": submit_t} if submit_t is not None else {}
        req = Request(rid=rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, **kwargs)
        if sampling is not None:
            req.sampling = sampling
        stream = TokenStream(req)
        self.streams[rid] = stream
        self.arrivals.append(req)
        return stream

    def cancel(self, rid: int) -> None:
        """Mark a request for cancellation (client disconnect).  Applied
        at the next tick boundary — never mid-tick."""
        if rid in self.streams and not self.streams[rid].closed:
            self._pending_cancel.add(rid)

    def _apply_cancellations(self) -> None:
        for rid in sorted(self._pending_cancel):
            stream = self.streams.pop(rid, None)
            # not yet drained into the engine: drop from arrivals directly
            for req in self.arrivals:
                if req.rid == rid:
                    self.arrivals.remove(req)
                    req.cancelled = True
                    req.done = True
                    self.engine.cancelled.append(req)
                    break
            else:
                self.engine.cancel_request(rid)
                self._ops.append(("cancel", rid))
            self.cancels += 1
            if stream is not None:
                stream.push("cancelled", {"rid": rid})
        self._pending_cancel.clear()

    def _drain_arrivals(self) -> None:
        """Admission-side host work: move up to ``admit_batch`` arrivals
        into the scheduler's ready queue.  Pure host mutation — safe to
        run while a dispatched tick's device work is still in flight."""
        for _ in range(min(self.knobs.admit_batch, len(self.arrivals))):
            req = self.arrivals.popleft()
            self.engine.submit(req)
            self._ops.append(("submit", req.rid, req.prompt,
                              req.max_new_tokens, req.sampling))

    # -- the followers' inputs (a multi-rank mesh) -------------------------
    def _sync(self, **msg) -> None:
        """Rank 0: broadcast the inputs applied since the last message
        (with ``msg``: ``tick``, ``policy``, ``stop``) to the followers."""
        if self.mesh is None:
            self._ops.clear()
            return
        broadcast_object({"ops": self._ops, **msg})
        self._ops = []
        self._last_sync = time.monotonic()
        self.syncs += 1

    def _apply_ops(self, ops: list[tuple]) -> None:
        """A follower: rank 0's submissions and cancellations, in order."""
        for op in ops:
            if op[0] == "submit":
                _, rid, prompt, max_new, sampling = op
                self.engine.submit(Request(rid=rid, prompt=list(prompt),
                                           max_new_tokens=max_new,
                                           sampling=sampling))
            else:
                self.engine.cancel_request(op[1])
                self.cancels += 1

    def follow(self) -> None:
        """The tick loop of ranks 1.. of a multi-rank mesh: receive rank
        0's messages and do what it did, until its stop message."""
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() runs on ranks 1.. of a multi-rank "
                               "mesh; rank 0 runs the gateway (run())")
        while True:
            msg = broadcast_object(None)
            self.syncs += 1
            self._apply_ops(msg["ops"])
            if msg.get("policy") is not None:
                self._run_policy(msg["policy"])
            if msg.get("stop"):
                return
            if msg.get("tick"):
                self.engine.schedule()
                self.engine.emit(self.engine.dispatch())
                self.ticks += 1

    # -- token routing ---------------------------------------------------
    def _flush_streams(self) -> None:
        done = []
        for rid, stream in self.streams.items():
            req = stream.req
            n = len(req.out_tokens)
            if n > stream.sent:
                stream.push("tokens", req.out_tokens[stream.sent:n])
                stream.sent = n
            if req.done:
                info = {
                    "rid": rid,
                    "n_tokens": n,
                    "queue_wait_s": (req.admit_t - req.submit_t
                                     if req.admit_t is not None else None),
                    "ttft_s": (req.first_token_t - req.submit_t
                               if req.first_token_t is not None else None),
                    "cached_tokens": req.cached_tokens,
                }
                stream.push("cancelled" if req.cancelled else "done", info)
                done.append(rid)
        for rid in done:
            self.streams.pop(rid, None)

    # -- the loop --------------------------------------------------------
    def _has_work(self) -> bool:
        return bool(self.arrivals or self.engine.active
                    or self.engine.scheduler.has_queued)

    async def run(self) -> None:
        """The pipelined tick loop; runs until :meth:`stop` (immediate)
        or :meth:`drain` (finish in-flight work first)."""
        loop = asyncio.get_running_loop()
        try:
            while not self._stopped:
                self._apply_cancellations()
                if not self._has_work():
                    if self._draining:
                        break
                    if (self.mesh is not None and time.monotonic()
                            - self._last_sync >= self.heartbeat_s):
                        self._sync()       # the followers' heartbeat
                    await asyncio.sleep(_IDLE_SLEEP_S)
                    continue
                self._drain_arrivals()
                before = (self.engine.steps, self.engine.prefill_chunks,
                          len(self.engine.finished),
                          len(self.engine.cancelled))
                t0 = time.perf_counter()
                self._sync(tick=True)
                self.engine.schedule()
                work = self.engine.dispatch()
                t1 = time.perf_counter()
                self.ticks += 1
                if work is not None and self.knobs.max_inflight > 1:
                    # double-buffered tick: the device computes while the
                    # host drains the next tick's arrivals and the event
                    # loop serves handlers; the wait itself runs in a
                    # worker thread so SSE writes flow during compute
                    self._drain_arrivals()
                    await loop.run_in_executor(None, work.block)
                    self.overlapped_ticks += 1
                    self.wait_s += time.perf_counter() - t1
                t2 = time.perf_counter()
                self.engine.emit(work)
                self.schedule_dispatch_s += t1 - t0
                self.emit_s += time.perf_counter() - t2
                self._flush_streams()
                self._policy_tick(time.monotonic())
                after = (self.engine.steps, self.engine.prefill_chunks,
                         len(self.engine.finished),
                         len(self.engine.cancelled))
                if after == before and not self.engine.active \
                        and self.engine.scheduler.has_queued:
                    raise RuntimeError(
                        "admission stalled: queued work cannot obtain a "
                        "lane or pages (page pool smaller than one "
                        "sequence?)")
                await asyncio.sleep(0)     # handlers run between ticks
            self._sync(stop=True)
        except BaseException as e:
            self._loop_error = e
            for stream in self.streams.values():
                stream.push("cancelled", {"error": str(e)})
            self.streams.clear()
            raise
        finally:
            self._flush_streams()

    def start(self) -> asyncio.Task:
        self._task = asyncio.get_running_loop().create_task(self.run())
        return self._task

    async def drain(self) -> None:
        """Graceful shutdown: refuse new work, serve out everything
        already admitted or queued, then stop."""
        self._draining = True
        if self._task is not None:
            await self._task

    def stop(self) -> None:
        self._stopped = True

    # -- reporting -------------------------------------------------------
    def stats(self) -> dict:
        eng = self.engine
        out = {
            "ticks": self.ticks,
            "overlapped_ticks": self.overlapped_ticks,
            "backlog": self.backlog,
            "active": len(eng.active),
            "finished": len(eng.finished),
            "cancelled": len(eng.cancelled),
            "cancels": self.cancels,
            "rejected_429": self.rejected,
            "syncs": self.syncs,
            "draining": self._draining,
            "policy": {"max_inflight": self.knobs.max_inflight,
                       "admit_batch": self.knobs.admit_batch},
            # the loop's host ms by tick phase, summed over the ticks
            "host_ms": {"schedule_dispatch": self.schedule_dispatch_s * 1e3,
                        "wait": self.wait_s * 1e3,
                        "emit": self.emit_s * 1e3},
            # pool precision + capacity (kv_dtype, pool_bytes,
            # kv_bytes_per_token, capacity_tokens) for /v1/stats clients
            "kv": eng.kv.stats(),
        }
        if self._gateway_region_live():
            out["policy"]["windows"] = self.policy_windows
            out["policy"]["committed"] = self.tuner.committed_gateway_params()
        return out
