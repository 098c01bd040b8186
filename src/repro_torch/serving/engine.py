"""Serving engine: continuous batching over fixed decode lanes, with
time-slice preemption, on the dense KV lanes or the paged KV pool.

The engine wires the scheduler (FIFO admission + preemption), a KV
backend (:mod:`.kvcache`), the sampler and the metrics layer to the
model's steps, as the JAX package's engine does:

* admission runs one monolithic prefill per request (kernel K1 on the
  card; K9 for a Mamba-1 stack, whose lane holds recurrent state) and
  copies its K/V (or state) into the lane's strip or pages; with
  ``prefill_chunk`` (paged only) a request is admitted with no compute
  and streams its prompt in chunk by chunk, one chunk per tick (kernel
  K4), so a long prompt never stalls the lanes that are decoding;
* every tick runs one batched decode step over all lanes (K2 on dense
  lanes, K3 on pages, K5 with ``num_splits``, K6 on int8 pages; plain
  tensor ops for a Mamba-1 stack), idle
  lanes riding along at position 0 and mid-prefill lanes with their
  table rows masked to the null page;
* with ``spec_k`` and a draft model (paged only) the tick is
  speculative: the draft (dense lanes, K1 catch-up prefill and K2
  decode) proposes up to ``spec_k`` tokens per lane, the target scores
  every candidate in one verify step over the pages (K4, or K5b + K5c
  with ``num_splits``; K6c / K6d over int8 pages), the accept/reject rule
  emits 1 .. k+1 tokens, and ``truncate_to`` rolls back the rejected
  drafts' pages;
* with ``prefix_cache`` (paged + chunked prefill) an admission is seeded
  with the indexed pages of its prompt's prefix and prefills from the
  first uncached token; every full prompt page a chunk commits is
  published back into the index, and a write into a shared page copies
  it first;
* under page pressure an admission waits at the head of the queue and a
  lane that cannot grow is preempted: its pages swap out to the host and
  it resumes first, by swap-in, where it stopped (mid-prefill too);
* each tick splits into ``schedule`` / ``dispatch`` / ``emit``:
  ``dispatch`` only launches device work and records a CUDA event
  (:class:`TickWork`), ``emit`` is the first host-device sync; the
  gateway's :class:`~repro_torch.serving.gateway.PipelinedEngine`
  waits on that event off the event loop;
* ``cancel_request`` aborts a request wherever it is (queued, preempted
  or on a lane) and returns its pages to the pool, at a tick boundary.
A request carries tokens only: a vision arch (pixtral-12b) is served
text-only, dense or paged, its patch projection unused, as the JAX
engine serves it; an encoder-decoder, whose prefill needs the encoder's
frames, is refused.

Greedy output is token-for-token the JAX engine's on the same weights
and requests, int8 pages, speculation and the prefix cache included.
``num_splits`` is handed to every paged decode and verify step, never to
prefill (``None`` leaves what run-time AT publishes to the kernels).
``prefix_min_match`` and ``prefix_eviction`` are the ``PrefixPolicy``
knobs as plain arguments.

The model's steps are the engine's attributes, as in the JAX engine:
``_decode`` (each tick's batched step), ``_prefill`` (an admission's
monolithic prefill), ``_prefill_step`` (a prompt chunk), ``_verify`` (a
speculative verify), ``_draft_prefill`` and ``_draft_decode`` (the
draft's).  ``decode_fn`` and ``prefill_fn`` replace the first two, with
the JAX engine's calls: ``decode_fn(params, caches, *extra, token,
pos)`` (``extra``: the page table on the paged pool) and
``prefill_fn(params, tokens, frontend_embeds, max_len)``, each returning
(logits, caches), and are called as given.  Where the JAX engine jits a
step the port compiles it (:mod:`.compiled`): ``_decode``,
``_prefill_step``, ``_verify`` and ``_draft_decode`` are
:class:`~repro_torch.serving.compiled.CompiledStep` wrappers, captured
once per shape as CUDA graphs and replayed (on the CPU they call the
step); ``_prefill`` and ``_draft_prefill``, one shape per prompt length,
and every step of an engine with a sharded ``mesh`` stay eager.  A
compiled step returns its graph's own output buffers, so the engine
reads a step's logits before it calls that step again (``emit`` before
the next ``dispatch``; the draft's and the verify's at once);
:meth:`graph_stats` counts the captures and replays.  ``greedy`` is
taken and changes nothing, as in the JAX engine: every request samples
by its own ``SamplingParams``.

Run-time AT (``autotuner``, a :class:`~repro_torch.tuning.DecodeAutoTuner`)
routes as the JAX engine does: each decode step through its length
bucket's ``DecodeBucket`` region (the bucket from the lanes' host-side
positions, no device read), each prefill chunk through its
``PrefillBucket`` region, each verify through its ``SpecBucket`` region
(measuring only until the bucket commits, drafting no further than the
committed window) and each prefix-cache admission through
``PrefixPolicy``; from ``dispatch`` and ``emit`` too, so the gateway's
loop routes the same way.

Tensor-parallel serving (``mesh``, a
:class:`~repro_torch.distributed.Mesh` whose ``"model"`` axis has m > 1
ranks; paged only) runs the engine SPMD, one engine a rank: every rank
holds the weights whole, its ``Hkv / m`` slice of the page pools, and
runs the paged decode, prefill chunk and verify steps head-sharded (the
kernels on its heads, the outputs all-gathered before ``wo``), and a
long causal monolithic prefill around the ring; the draft runs
replicated, as in the JAX engine.  Every host decision is taken once:
rank 0's sampled tokens (admission, decode, the draft's proposals and
the accept rule's result) are broadcast to every rank, and so are its
run-time AT commits (:mod:`repro_torch.tuning.ranks`), so the ranks stay
in step and their collectives meet.  A 1-rank model axis (``"1x1"``)
takes the unsharded path exactly.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..distributed.collectives import broadcast_object
from ..kernels.ops import mesh_model_axis
from . import sampling
from .buckets import LENGTH_BUCKETS
from .compiled import compile_step, graph_stats
from .kvcache import DenseKVCache, make_kv_cache
from .metrics import ServingMetrics
from .scheduler import LaneState, Request, Scheduler

__all__ = ["ServingEngine", "Request", "LaneState", "TickWork",
           "length_bucket"]



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
                 decode_fn: Callable | None = None,
                 prefill_fn: Callable | None = None,
                 greedy: bool = True, cache: str = "dense",
                 n_pages: int | None = None, page_size: int = 16,
                 timeslice: int | None = None, autotuner=None,
                 prefill_chunk: int | None = None, draft_model=None,
                 draft_params: dict | None = None,
                 spec_k: int | None = None, prefix_cache: bool = False,
                 prefix_min_match: int = 1, prefix_eviction: str = "lru",
                 kv_dtype: str = "fp", swap_compress: bool = False,
                 num_splits: int | None = None, mesh=None):
        if model.cfg.is_encoder_decoder:
            raise ValueError(
                f"{model.cfg.name!r} is an encoder-decoder: its prefill "
                "needs the encoder's frames, and a request carries none "
                "(the JAX ServingEngine passes none either, so neither "
                "package serves it); run it through Model.prefill("
                "frontend_embeds=...) and Model.decode_step")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.n_lanes = n_lanes
        self.max_len = max_len
        self.eos_id = eos_id
        # tensor-parallel serving: a mesh with a multi-rank "model" axis
        # shards the page pools' KV heads and runs the paged steps
        # head-sharded; a 1-rank mesh (or None) takes the unsharded paths
        self.mesh = mesh if mesh_model_axis(mesh) > 1 else None
        self.kv = make_kv_cache(model, cache, n_lanes, max_len, self.device,
                                n_pages=n_pages, page_size=page_size,
                                kv_dtype=kv_dtype,
                                swap_compress=swap_compress,
                                prefix_cache=prefix_cache,
                                prefix_min_match=prefix_min_match,
                                prefix_eviction=prefix_eviction,
                                mesh=self.mesh)
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
        if prefix_cache and prefill_chunk is None:
            raise ValueError(
                "prefix caching admits at the first uncached token via "
                "chunked prefill; pass prefill_chunk")
        self.prefill_chunk = prefill_chunk
        # the steps every tick calls are compiled (CUDA graphs on the
        # card, serving/compiled.py), as the JAX engine jits them.  Under
        # a sharded mesh they stay eager: on one card the collectives go
        # through gloo, which stages CUDA tensors through the host, and a
        # graph cannot capture that
        compiled = (lambda fn, name: fn) if self.mesh is not None \
            else compile_step
        self._decode = decode_fn or compiled(
            functools.partial(model.paged_decode_step, num_splits=num_splits,
                              mesh=self.mesh)
            if self.kv.kind == "paged" else model.decode_step, "decode")
        # the steps close over the model and the mesh, never over the
        # engine: a cycle through it would keep its KV pools alive until
        # the cycle collector runs
        mesh = self.mesh
        # the monolithic prefill stays eager: it has one shape per prompt
        # length (the JAX engine traces it per length), and a graph per
        # length would hold a memory pool per length
        self._prefill = prefill_fn or (
            lambda p, tokens, frontend_embeds, max_len: model.prefill(
                p, tokens, max_len, frontend_embeds=frontend_embeds,
                mesh=mesh))
        # a prompt chunk is padded to prefill_chunk tokens: one shape, one
        # graph a serve (a tuned chunk's tiles key their own)
        self._prefill_step = compiled(
            functools.partial(model.paged_prefill_step, mesh=mesh),
            "prefill_step")
        # -- speculative decoding ------------------------------------------
        self.spec_k = spec_k
        self.draft_model = draft_model
        self.draft_params = draft_params
        if spec_k is not None:
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if draft_model is None or draft_params is None:
                raise ValueError(
                    "speculative decoding needs a draft model: pass "
                    "draft_model + draft_params (see ArchConfig."
                    "draft_config / Model.slice_draft_params)")
            if self.kv.kind != "paged":
                raise ValueError(
                    "speculative decoding verifies drafts through the "
                    "paged chunk kernels; use cache='paged'")
            # the draft keeps dense per-lane strips: rollback is a position
            # reset (stale K/V past the committed point is masked by kv_len
            # and overwritten by the next draft), and a preempted or new
            # lane rebuilds it with one draft prefill
            self.draft_kv = DenseKVCache(draft_model, n_lanes, max_len,
                                         self.device)
            self.draft_pos = [0] * n_lanes   # tokens in the draft's cache
            self._verify = compiled(
                functools.partial(model.speculative_step,
                                  num_splits=num_splits, mesh=self.mesh),
                "verify")
            # the draft's methods are looked up at each call, so that a
            # wrapper of the model class's methods set after the engine
            # is built sees them (chip_smoke.py counts the draft's calls);
            # its prefill, one shape per length, stays eager
            self._draft_decode = compiled(
                lambda *args: draft_model.decode_step(*args), "draft_decode")
            self._draft_prefill = (
                lambda p, tokens, frontend_embeds, max_len:
                draft_model.prefill(p, tokens, max_len,
                                    frontend_embeds=frontend_embeds))
        # run-time AT: a tuning.dynamic.DecodeAutoTuner whose regions take
        # the decode steps, prefill chunks, verifies and prefix admissions
        # they declare (under a mesh, its variants bind the mesh and its
        # session decides on rank 0: tuning.ranks); None keeps the plain
        # paths
        self.autotuner = autotuner
        self.scheduler = Scheduler(n_lanes, timeslice=timeslice)
        self.metrics = ServingMetrics()
        self.active: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.cancelled: list[Request] = []
        self.steps = 0
        self.prefill_chunks = 0          # chunk steps run (chunked prefill)
        self.spec_ticks = 0              # speculative ticks run
        self.drafted_tokens = 0          # draft tokens offered to verify
        self.accepted_tokens = 0         # draft tokens accepted

    # -- compat views -------------------------------------------------------
    @property
    def lanes(self) -> list[LaneState]:
        return self.scheduler.lanes

    @property
    def queue(self):
        return self.scheduler.waiting

    @property
    def caches(self):
        return self.kv.caches

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

    def cancel_request(self, rid: int) -> bool:
        """Abort a request wherever it lives — queued, preempted, or on a
        lane — releasing its lane and KV pages (refcounts on shared prefix
        pages drop; the pool's three-state accounting balances) and
        resetting the lane's draft strip.

        The client-disconnect path of the gateway.  Cancelled requests do
        not feed the latency metrics (a half-served stream has no honest
        TTFT/ITL) and go to :attr:`cancelled`, not :attr:`finished`.
        Call it only at a tick boundary, never between :meth:`dispatch`
        and :meth:`emit`: the caches are written in place on the current
        stream, so the in-flight tick may still be writing the pages a
        cancel would return to the pool (and its batch still names the
        lane).  Returns False when ``rid`` is unknown (already finished
        or never submitted)."""
        req = self.active.pop(rid, None)
        if req is not None:
            lane_id = next(i for i, l in enumerate(self.scheduler.lanes)
                           if l.rid == rid)
            self.kv.release(lane_id)
            self.scheduler.vacate(lane_id)
            self._reset_draft(lane_id)
        else:
            req = self.scheduler.remove_queued(rid)
            if req is None:
                return False
        req.done = True
        req.cancelled = True
        req.finish_t = time.monotonic()
        self.cancelled.append(req)
        return True

    def _is_eos(self, tok: int) -> bool:
        """``eos_id=0`` is a valid stop token; ``None`` disables EOS."""
        return self.eos_id is not None and tok == self.eos_id

    def _decide(self, value):
        """Rank 0's ``value`` on every rank of the mesh's world (``value``
        itself without a sharded mesh): every host decision goes through
        here, so the ranks take the same path and meet in every
        collective."""
        return value if self.mesh is None else broadcast_object(value)

    def _next_token(self, req: Request, logits: torch.Tensor) -> int:
        """The request's next token from one logits row, keyed by its
        emission index (greedy = exact argmax)."""
        return self._decide(sampling.sample_token(
            logits.cpu().numpy(), req.sampling, len(req.out_tokens)))

    def _reset_draft(self, lane_id: int) -> None:
        """Invalidate the draft's cache for a (re)occupied lane; the next
        speculative tick rebuilds it with one draft prefill."""
        if self.spec_k is not None:
            self.draft_pos[lane_id] = 0

    def _tuned(self, family: str) -> bool:
        """Does the tuner declare the region family (``prefill_regions``,
        ``spec_regions``, ``prefix_region``)?"""
        return self.autotuner is not None \
            and bool(getattr(self.autotuner, family, None))

    def _seed_prefix(self, lane_id: int, req: Request) -> int:
        """Match and seed one admission through the prefix cache, through
        the tuner's ``PrefixPolicy`` region when it declares one (its
        alternatives set their (min match x eviction) knobs first; output
        is the same under every policy).  Returns the prefill start
        position and stamps the request."""
        if not self.kv.prefix_cache:
            return 0
        if self._tuned("prefix_region"):
            out = self.autotuner.prefix_policy(self.kv, lane_id, req.prompt)
            cached = out["cached"] if isinstance(out, dict) else int(out)
        else:
            cached = self.kv.seed_prefix(lane_id, req.prompt)
        req.cached_tokens = cached
        return cached

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
                self._reset_draft(lane_id)
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
                # prefix caching: the lane's leading table rows take the
                # indexed pages of the prompt's prefix, and prefill starts
                # at the first uncached token
                cached = self._seed_prefix(lane_id, req)
                if req.admit_t is None:
                    req.admit_t = time.monotonic()   # queue wait ends here
                self.scheduler.occupy(lane_id, req, cached,
                                      req.max_new_tokens, phase="prefill")
                self._reset_draft(lane_id)
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
            logits, cache1 = self._prefill(
                self.params, tokens, None,
                self.kv.prefill_len(len(req.prompt)))
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
            self._reset_draft(lane_id)
            self.active[req.rid] = req
            if req.max_new_tokens <= 1 or self._is_eos(tok):
                self._finish(lane_id, req, now)

    def _prefill_tick(self) -> None:
        """One prefill chunk for every mid-prefill lane.

        Each lane streams ``prefill_chunk`` prompt tokens into its pages
        per tick (pages allocated chunk by chunk, the ragged last chunk
        padded into the null page).  The final chunk's last valid row
        gives the request's first token (TTFT stamps here).  A lane that
        cannot get the chunk's pages (or the copy of a shared page its
        first write lands in) is preempted mid-prefill and resumes where
        it stopped.  Every prompt page a chunk fills is published into
        the prefix index."""
        if self.prefill_chunk is None:
            return
        c = self.prefill_chunk
        for lane_id in self.scheduler.prefill_lanes():
            lane = self.scheduler.lanes[lane_id]
            req = self.active[lane.rid]
            plen = len(req.prompt)
            start, end = lane.pos, min(lane.pos + c, plen)
            # copy-on-write: a fully cached page-aligned prompt starts
            # prefill at plen - 1, inside its last shared page
            if not self.kv.ensure_tokens(lane_id, end) \
                    or not self.kv.cow_writable(lane_id, start):
                if len(self.active) == 1:
                    raise RuntimeError(
                        f"page pool too small: sequence {lane.rid} needs "
                        f"pages for prompt positions [{start}, {end}) and "
                        "no other lane can be evicted")
                self._preempt_lane(lane_id, priority=True)
                continue
            chunk = req.prompt[start:end] + [0] * (c - (end - start))
            args = (self.params, self.kv.caches, self.kv.table_row(lane_id),
                    torch.tensor([chunk], dtype=torch.long,
                                 device=self.device),
                    torch.tensor([start], device=self.device),
                    torch.tensor([end], device=self.device),
                    torch.tensor([end - start - 1], device=self.device))
            if self._tuned("prefill_regions"):
                logits, _ = self.autotuner.prefill(plen, c, *args)
            else:
                logits, _ = self._prefill_step(*args)
            self.prefill_chunks += 1
            lane.pos = end
            self.kv.publish_prefix(lane_id, req.prompt, end)
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

    # -- speculative decode: draft, verify, accept, roll back ---------------
    def _spec_capacity(self) -> tuple[dict[int, int], int]:
        """Each decoding lane's draft length for this tick, and the
        sequence length that keys the tick's ``SpecBucket`` region.  The
        length is taken once, before this loop's preemptions, so the
        region that capped the drafting is the one that verifies it.  The
        draft length is ``spec_k`` (with a tuner whose bucket has
        committed, the winner's window) clamped by the lane's remaining
        budget, by ``max_len`` (verify writes K/V at ``pos .. pos + k``)
        and by the pages it can get; a lane that cannot get even the page
        of one token is preempted."""
        seq = max((self.scheduler.lanes[j].pos + 1
                   for j in self.scheduler.decode_lanes()), default=1)
        cap = self.spec_k
        if self._tuned("spec_regions"):
            cap = self.autotuner.spec_draft_k(seq, self.spec_k)
        k_eff: dict[int, int] = {}
        for i in list(self.scheduler.decode_lanes()):
            lane = self.scheduler.lanes[i]
            ke = max(0, min(cap, lane.remaining - 1,
                            self.max_len - 1 - lane.pos))
            while ke >= 0 and not self.kv.ensure_tokens(i, lane.pos + ke + 1):
                ke -= 1
            if ke < 0:
                if len(self.active) == 1:
                    raise RuntimeError(
                        f"page pool too small: sequence {lane.rid} needs "
                        f"another page at pos {lane.pos} and no other "
                        "lane can be evicted")
                self._preempt_lane(i, priority=True)
                continue
            k_eff[i] = ke
        return k_eff, seq

    def _draft_propose(self, k_eff: dict[int, int]) -> tuple[dict, dict]:
        """Up to ``k_eff[i]`` draft tokens per decoding lane.

        The draft's cache trails the committed sequence: a lane whose
        cache is empty or more than two tokens behind (new admission,
        resume) catches up with one draft prefill over the committed
        tokens (K1 at that length); otherwise the missing 1-2 tokens feed
        through the batched draft decode steps (K2) with the proposals.
        Lanes with nothing to feed ride the batch at the dead slot
        ``max_len - 1`` (never read: live lanes finish at ``max_len -
        2``).  Returns ({lane: draft tokens}, {lane: draft probs})."""
        drafts: dict[int, list[int]] = {i: [] for i in k_eff}
        dprobs: dict[int, list] = {i: [] for i in k_eff}
        pending: dict[int, list[int]] = {}
        rngs, sps = {}, {}
        for i, ke in k_eff.items():
            if ke == 0:
                continue
            req = self.active[self.scheduler.lanes[i].rid]
            sps[i] = req.sampling
            rngs[i] = sampling.draft_rng(req.sampling, len(req.out_tokens))
            all_toks = req.prompt + req.out_tokens   # len == lane.pos + 1
            if self.draft_pos[i] == 0 or len(all_toks) - self.draft_pos[i] > 2:
                logits_d, dcache = self._draft_prefill(
                    self.draft_params,
                    torch.tensor([all_toks], dtype=torch.long,
                                 device=self.device), None, self.max_len)
                self.draft_kv.admit(i, dcache, len(all_toks))
                self.draft_pos[i] = len(all_toks)
                tok, q = sampling.propose_token(logits_d[0].cpu().numpy(),
                                                sps[i], rngs[i])
                drafts[i].append(self._decide(tok))
                dprobs[i].append(q)
                pending[i] = []
            else:
                pending[i] = all_toks[self.draft_pos[i]:]
        while True:
            feed: dict[int, int] = {}
            for i, ke in k_eff.items():
                if ke == 0:
                    continue
                if pending[i]:
                    feed[i] = pending[i][0]
                elif 0 < len(drafts[i]) < ke:
                    feed[i] = drafts[i][-1]   # extend the draft chain
            if not feed:
                break
            token = np.zeros((self.n_lanes, 1), np.int64)
            pos = np.full((self.n_lanes,), self.max_len - 1, np.int64)
            for i, t in feed.items():
                token[i, 0] = t
                pos[i] = self.draft_pos[i]
            logits_d, _ = self._draft_decode(
                self.draft_params, self.draft_kv.caches,
                torch.from_numpy(token).to(self.device),
                torch.from_numpy(pos).to(self.device))
            # read now: the next draft decode replays into this buffer
            logits_np = logits_d.cpu().numpy()
            proposed = {}
            for i in feed:
                self.draft_pos[i] += 1
                if pending[i]:
                    pending[i].pop(0)
                    if pending[i]:
                        continue           # still catching up
                proposed[i] = sampling.propose_token(logits_np[i], sps[i],
                                                     rngs[i])
            toks = self._decide({i: tok for i, (tok, _) in proposed.items()})
            for i, (_, q) in proposed.items():
                drafts[i].append(toks[i])
                dprobs[i].append(q)
        return drafts, dprobs

    def _spec_tick(self) -> None:
        """One speculative decode tick over the decoding lanes: draft,
        one batched verify of every lane's candidate chunk (its K/V
        written into the pages), the accept rule, and ``truncate_to`` of
        the pages past each lane's committed point.  Idle and mid-prefill
        lanes ride the verify with ``kv_len`` 0 and, mid-prefill, their
        table rows masked, so their chunk sinks into the null page."""
        k_eff, seq = self._spec_capacity()
        decoding = self.scheduler.decode_lanes()
        if not decoding:
            return
        drafts, dprobs = self._draft_propose(k_eff)
        c = self.spec_k + 1
        tokens = np.zeros((self.n_lanes, c), np.int64)
        start = np.zeros((self.n_lanes,), np.int64)
        kv_len = np.zeros((self.n_lanes,), np.int64)
        for i in decoding:
            lane = self.scheduler.lanes[i]
            row = [self.active[lane.rid].out_tokens[-1]] + drafts[i]
            tokens[i, :len(row)] = row
            start[i] = lane.pos
            kv_len[i] = lane.pos + len(row)
        extra = self.kv.decode_extra(
            mask_lanes=self.scheduler.prefill_lanes())
        args = (self.params, self.kv.caches, *extra,
                *(torch.from_numpy(a).to(self.device)
                  for a in (tokens, start, kv_len)))
        if self._tuned("spec_regions"):
            # the key _spec_capacity capped the drafting with; the region
            # measures (syncing, and the accept proxy) until it commits
            out = self.autotuner.spec(
                seq, *args, measure=not self.autotuner.spec_committed(seq))
            logits = out["logits"] if isinstance(out, dict) else out[0]
        else:
            logits, _ = self._verify(*args)
        logits_np = logits.cpu().numpy()
        # a tuned variant may verify a narrower chunk (its window k): the
        # drafts past it are rejected, their K/V never written
        window_max = logits_np.shape[1] - 1
        reqs = {i: self.active[self.scheduler.lanes[i].rid] for i in decoding}
        windows = {i: min(len(drafts[i]), window_max) for i in decoding}
        accepted = self._decide({i: sampling.speculative_accept(
            drafts[i][:w], dprobs[i][:w], logits_np[i, :w + 1],
            reqs[i].sampling, len(reqs[i].out_tokens))
            for i, w in windows.items()})
        now = time.monotonic()
        self.steps += 1
        self.spec_ticks += 1
        for i in decoding:
            lane, req, w = self.scheduler.lanes[i], reqs[i], windows[i]
            emitted, n_acc = accepted[i]
            self.drafted_tokens += w
            self.accepted_tokens += n_acc
            committed = lane.pos + n_acc + 1
            self.kv.truncate_to(i, committed)
            emit = []
            for tok in emitted:
                emit.append(tok)
                if self._is_eos(tok):
                    break
            req.out_tokens.extend(emit)
            req.token_ts.extend([now] * len(emit))
            lane.pos = committed
            lane.remaining -= len(emit)
            lane.steps_served += 1
            lane.tokens_served += len(emit)
            self.draft_pos[i] = min(self.draft_pos[i], committed)
            if lane.remaining <= 0 or self._is_eos(emit[-1]) \
                    or lane.pos >= self.max_len - 1:
                self._finish(i, req, now)

    def spec_stats(self) -> dict:
        """Speculation counters (zeros when speculation is off)."""
        return {
            "spec_k": self.spec_k,
            "spec_ticks": self.spec_ticks,
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "accept_rate": (self.accepted_tokens / self.drafted_tokens
                            if self.drafted_tokens else 0.0),
        }

    def graph_stats(self) -> dict:
        """The captures, replays, recaptures and graphs (by step) of this
        engine's compiled steps and of its tuner's variants."""
        return graph_stats([
            self._decode, self._prefill_step, getattr(self, "_verify", None),
            getattr(self, "_draft_decode", None),
            *getattr(self.autotuner, "compiled_steps", ())])

    def tuning_db(self) -> dict | None:
        """Which tuning DB feeds this engine's regions (backend, path,
        record count, golden overlay), None when serving untuned."""
        session = getattr(self.autotuner, "session", None)
        return None if session is None else session.records.describe()

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
        :meth:`emit`.  Speculative ticks run here whole (their accept
        rule is host-side) and return None, as does a tick with no lane
        decoding."""
        if self.spec_k is not None:
            self._spec_tick()
            return None
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
        args = (self.params, self.kv.caches, *extra,
                torch.from_numpy(token).to(self.device),
                torch.from_numpy(pos).to(self.device))
        if self.autotuner is not None:
            # the bucket from the host's own lane positions: no device read
            logits, _ = self.autotuner.decode(int(pos.max()) + 1, *args)
        else:
            logits, _ = self._decode(*args)
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
        # the decode graph's own buffer: read before the next dispatch
        # replays the graph into it
        logits_np = work.logits.cpu().numpy()
        toks = self._decide(sampling.sample_batch(
            logits_np[work.decoding], [r.sampling for r in work.reqs],
            [len(r.out_tokens) for r in work.reqs]))
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
