"""Run-time AT: serving-time variant selection per request bucket.

The paper's ``dynamic select`` (Samples 6/7) applied to the decode path:
each sequence-length bucket gets a dynamic AT region whose alternatives
are decode implementations; the first calls in each bucket measure the
candidates (run-time auto-tuning happens at the call site, §4.1), then the
winner is committed and ``OAT_DynPerfThis`` semantics apply — later calls
run the optimised variant with no tuning.

The BP space is (length bucket × block_k) for the dense decode kernel
and, when ``page_sizes`` is given, the full (length bucket × block_k ×
page_size) product for the paged path (arXiv 2312.05779's bucket-wise
runtime re-selection, with the page-gather granularity as the second
axis).  ``num_splits`` adds the split-KV *parallelism degree* as a third
axis — per the ppOpen-AT follow-up, the number of parallel workers
belongs in the tuned space alongside tile shape — with ``num_splits=1``
(the sequential kernel) always present so short buckets can commit the
no-split variant and legacy winners remain valid spellings.

Chunked prefill adds a second tunable region family
(:meth:`DecodeAutoTuner.add_prefill`): one ``dynamic select`` per
(prompt-length bucket × chunk size) whose alternatives are
``flash_paged_prefill`` tile assignments (block_q × block_k) — the
prefill hot path becomes a tuning region exactly like decode did.

Speculative decoding adds a third (:meth:`DecodeAutoTuner.add_spec`):
one ``SpecBucket_{b}`` ``dynamic select`` per sequence-length bucket over
the (k × verify block_q × block_k) product — the accept/reject policy's
window k is itself a tuned parameter (Xabclib-style fully auto-tuned
policy selection), alongside the verify kernel's tile.  A variant with a
smaller k verifies a narrower chunk of the drafted tokens; greedy output
is bit-identical for every k, so the region is free to measure and
commit whichever trades acceptance against verify cost best per bucket.

Prefix caching adds a fourth (:meth:`DecodeAutoTuner.add_prefix_policy`):
a single ``PrefixPolicy`` ``dynamic select`` over the cache's *reuse
policy* product (minimum match granularity × eviction strategy).  Like
the spec region this tunes pure policy, not kernel tiles — the ANTAREX
separation of adaptation policy from functional code: outputs are
bit-identical under every candidate, so the region measures admissions
freely and commits per its ``according`` criterion (default: the policy
whose admissions leave the fewest uncached prompt tokens).

Quantized paged KV adds a sixth (:meth:`DecodeAutoTuner.add_kv_precision`):
one ``KVPrecision_{b}`` ``dynamic select`` per sequence-length bucket over
the (kv precision × block_k) product — fp pages vs int8 pages with
in-kernel dequant.  Unlike every other region family the candidates are
*not* output-identical: int8 pages round each K/V row through a per-row
scale, so the region's ``according`` couples latency to a quality guard
(``min (time_per_token) .and. condition (agreement >= floor)``) — a
quantized candidate may only win if its greedy tokens agree with the fp
reference at or above the floor.  fp candidates report agreement 1.0 by
construction, so the region can never commit to an empty pool.

The serving gateway adds a fifth (:meth:`DecodeAutoTuner.add_gateway`):
a single ``GatewayPolicy`` ``dynamic select`` over the gateway's
concurrency product (pipeline depth × admission batch).  Candidates are
measured over *windows* of live traffic rather than single calls, and
the criterion is ``min (time_per_good_token)`` — the inverse of goodput,
tokens from within-SLO requests per wall second.

Declared through the ``repro_torch.at`` session: committed winners (decode,
prefill, spec, prefix-policy and gateway-policy alike) persist in the
session's record store, so a restarted server starts every region
already committed (no first-call tuning jitter on the warm path).

Every bucketed region family keys off the shared
:mod:`repro_torch.serving.buckets` ladders — one table, no drift between the
declaring and the routing side.
"""
from __future__ import annotations

from typing import Callable

from .. import at
from ..core import ATContext
from ..serving.buckets import LENGTH_BUCKETS
from ..serving.engine import length_bucket

DEFAULT_BLOCK_KS = (256, 512, 1024)


def divisor_block_ks(page_size: int, block_ks) -> tuple[int, ...]:
    """Filter candidate ``block_k`` tiles to divisors of ``page_size``.

    The paged kernels require the split-K tile to divide the page; a
    non-divisor candidate silently coerces to the whole page inside the
    kernel (now with a warning), so tuning it would measure a duplicate
    of the ``block_k=page_size`` candidate under a misleading label.
    Candidates are clamped to the page first (a tile larger than the
    page is the whole-page tile), deduplicated preserving order, and the
    whole page itself is the fallback when nothing survives.
    """
    out: list[int] = []
    for bk in block_ks:
        bk = min(int(bk), page_size)
        if bk > 0 and page_size % bk == 0 and bk not in out:
            out.append(bk)
    return tuple(out) or (page_size,)


def page_block_ks(page_size: int, block_ks) -> tuple[int, ...]:
    """The Hopper counterpart of :func:`divisor_block_ks` for the port's
    ladders: the candidate ``block_k`` tiles that are whole pages.

    On the card a ``block_k`` is keys per K/V tile of the decode or
    prefill kernel, spanning whole pages (the TPU kernel's was a sub-page
    tile that had to divide the page), and a tile exists only where the
    kernel has an instance (``kernels.paged_attention.decode_block_ks``,
    ``prefill_tiles``): so ``block_ks`` are instantiated tiles, and those
    that are multiples of ``page_size`` survive, deduplicated preserving
    order.  When none does (pages larger than every tile), the largest
    tile, the nearest to a whole page, is the one candidate.
    """
    out: list[int] = []
    for bk in block_ks:
        bk = int(bk)
        if bk >= page_size and bk % page_size == 0 and bk not in out:
            out.append(bk)
    return tuple(out) or (max(int(bk) for bk in block_ks),)


# -- region naming ----------------------------------------------------------
#
# Canonical region names.  With no mesh (or any 1-device mesh) the
# canonical names ARE the historical ad-hoc strings — which is what lets
# pre-mesh tuning DBs warm-load unchanged — while a multi-device mesh
# appends a ``_mesh{R}x{C}`` suffix so winners are tuned and persisted per
# mesh shape (arXiv 1309.1894: a winner is only valid in the environment
# that measured it, and the parallelism degree is part of the environment).

_REGION_FORMATS = {
    "decode": "DecodeBucket_{bucket}",
    "prefill": "PrefillBucket_{bucket}_c{chunk}",
    "spec": "SpecBucket_{bucket}",
    "kv_precision": "KVPrecision_{bucket}",
    "prefix": "PrefixPolicy",
    "gateway": "GatewayPolicy",
}

#: Legacy name prefix -> canonical kind.  Pre-mesh tuning DBs recorded
#: exactly these strings; :func:`region_key` still emits them whenever the
#: mesh has one device, so existing records warm-load with zero re-tuning.
LEGACY_REGION_ALIASES = {
    "DecodeBucket": "decode",
    "PrefillBucket": "prefill",
    "SpecBucket": "spec",
    "KVPrecision": "kv_precision",
    "PrefixPolicy": "prefix",
    "GatewayPolicy": "gateway",
}


def normalize_mesh_shape(mesh_shape) -> tuple[int, ...]:
    """Normalize a mesh shape given as ``None``, an ``"RxC"`` string, an
    int, or an iterable of ints into a tuple of ints (``()`` == no mesh)."""
    if mesh_shape is None:
        return ()
    if isinstance(mesh_shape, str):
        parts = [p for p in mesh_shape.lower().split("x") if p]
        try:
            return tuple(int(p) for p in parts)
        except ValueError:
            raise ValueError(
                f"bad mesh shape {mesh_shape!r}: expected 'RxC' like '1x4'"
            ) from None
    if isinstance(mesh_shape, int):
        return (mesh_shape,)
    return tuple(int(d) for d in mesh_shape)


def mesh_suffix(mesh_shape) -> str:
    """The region-name suffix for a mesh shape: empty for no mesh or any
    1-device mesh (those runs are bit-identical to the unsharded engine,
    so they share its winners), ``_mesh{R}x{C}`` otherwise."""
    shape = normalize_mesh_shape(mesh_shape)
    n = 1
    for d in shape:
        n *= d
    if n <= 1:
        return ""
    return "_mesh" + "x".join(str(d) for d in shape)


def region_key(kind: str, bucket: int | None = None, *,
               chunk: int | None = None, mesh_shape=None) -> str:
    """Build the canonical region name for one tuning region.

    ``kind`` is one of ``decode`` / ``prefill`` / ``spec`` /
    ``kv_precision`` / ``prefix`` / ``gateway``; bucketed kinds require
    ``bucket`` and prefill additionally requires ``chunk``.  The
    ``mesh_shape`` axis keys winners per execution environment — a
    1-device shape collapses to the legacy (unsuffixed) name.
    """
    fmt = _REGION_FORMATS.get(kind)
    if fmt is None:
        raise ValueError(
            f"unknown region kind {kind!r}: expected one of "
            f"{sorted(_REGION_FORMATS)}")
    if "{bucket}" in fmt and bucket is None:
        raise ValueError(f"{kind!r} regions are bucketed: pass bucket")
    if "{chunk}" in fmt and chunk is None:
        raise ValueError(f"{kind!r} regions need chunk= (one region per "
                         f"bucket x chunk size)")
    return fmt.format(bucket=bucket, chunk=chunk) + mesh_suffix(mesh_shape)


def parse_region(name: str) -> tuple[str, int | None, int | None,
                                     tuple[int, ...]]:
    """Split a region name into ``(kind, bucket, chunk, mesh_shape)``.

    Understands both legacy (unsuffixed) and mesh-suffixed names via
    :data:`LEGACY_REGION_ALIASES`.  Raises ``KeyError`` for names no
    alias matches.
    """
    base, _, mesh = name.partition("_mesh")
    shape = normalize_mesh_shape(mesh) if mesh else ()
    for prefix, kind in LEGACY_REGION_ALIASES.items():
        if base == prefix:
            return kind, None, None, shape
        if base.startswith(prefix + "_"):
            rest = base[len(prefix) + 1:]
            try:
                if kind == "prefill":
                    b, _, c = rest.partition("_c")
                    return kind, int(b), int(c), shape
                return kind, int(rest), None, shape
            except ValueError:
                break
    raise KeyError(name)


def describe_region(name: str) -> dict | None:
    """Parse a region name into a display record for the ``repro_torch.at``
    CLI: ``{"kind", "bucket", "chunk", "mesh"}`` (``mesh`` is the
    ``"RxC"`` spelling, ``""`` for legacy/unsuffixed names).  ``None``
    for names outside the serving families (install/static kernel
    regions enumerate under their literal names instead)."""
    try:
        kind, bucket, chunk, shape = parse_region(name)
    except (KeyError, ValueError):
        return None
    return {"kind": kind, "bucket": bucket, "chunk": chunk,
            "mesh": "x".join(str(d) for d in shape)}


def resolve_region(name: str) -> str:
    """Canonicalize a possibly-legacy region name through the alias
    table.  Today every legacy name is already canonical (that identity
    is what keeps old tuning DBs warm-loading), so unknown names pass
    through unchanged rather than erroring."""
    try:
        kind, bucket, chunk, shape = parse_region(name)
    except (KeyError, ValueError):
        return name
    return region_key(kind, bucket, chunk=chunk, mesh_shape=shape or None)


class DecodeAutoTuner:
    """Per-bucket dynamic select over decode variants.

    ``make_decode(block_k)`` — or ``make_decode(block_k, page_size)`` when
    ``page_sizes`` is given — builds one decode callable per variant; the
    region measures each candidate once and commits the fastest.

    ``num_splits`` grows the space with the split-KV parallelism degree
    (``make_decode`` then takes it as its last positional): the variant
    list is ordered with the full legacy (``num_splits=1``) block first,
    so winner *indices* recorded by a pre-split-KV tuning DB still name
    the same variants — those records stay valid spellings (the
    record-store ``OAT_NUMALT`` stamp decides whether they warm-load or
    the grown region re-measures).
    """

    def __init__(self, session: "at.AutoTuner | ATContext",
                 make_decode: Callable[..., Callable],
                 buckets=LENGTH_BUCKETS,
                 block_ks=DEFAULT_BLOCK_KS,
                 page_sizes=None,
                 num_splits=None,
                 mesh_shape=None):
        self.session = at.AutoTuner.for_context(session)
        self.ctx = self.session.ctx
        self.buckets = buckets
        # winners are keyed per mesh shape (1-device shapes collapse to
        # the legacy names, so unsharded winners keep warm-loading)
        self.mesh_shape = normalize_mesh_shape(mesh_shape)
        self.param_names = ("block_k",) if page_sizes is None \
            else ("block_k", "page_size")
        self.variants = [(bk,) for bk in block_ks] if page_sizes is None \
            else [(bk, ps) for bk in block_ks for ps in page_sizes]
        if num_splits is not None:
            # 1 (the sequential kernel) always leads, and the ns=1 block
            # keeps the legacy variant order as its prefix
            splits = tuple(dict.fromkeys([1, *(int(n) for n in num_splits)]))
            self.param_names = (*self.param_names, "num_splits")
            self.variants = [(*var, ns) for ns in splits
                             for var in self.variants]
        self.regions = {}
        for b in buckets:
            name = self._key("decode", b)
            sel = self.session.autotune("dynamic", "select", name=name)
            for var in self.variants:
                label = ",".join(f"{k}={v}"
                                 for k, v in zip(self.param_names, var))
                sel.alternative(name=label)(make_decode(*var))
            self.regions[b] = sel.region
        self.prefill_buckets: tuple = ()
        self.prefill_variants: list[tuple] = []
        self.prefill_param_names: tuple = ()
        self.prefill_regions: dict[tuple[int, int], object] = {}
        self.spec_buckets: tuple = ()
        self.spec_variants: list[tuple] = []
        self.spec_param_names: tuple = ()
        self.spec_regions: dict[int, object] = {}
        self.prefix_variants: list[tuple] = []
        self.prefix_param_names: tuple = ()
        self.prefix_region = None
        self.gateway_variants: list[tuple] = []
        self.gateway_param_names: tuple = ()
        self.gateway_region = None
        self.kv_buckets: tuple = ()
        self.kv_variants: list[tuple] = []
        self.kv_param_names: tuple = ()
        self.kv_regions: dict[int, object] = {}
        self.session.run("dynamic",
                         [self._key("decode", b) for b in buckets])

    def _key(self, kind: str, bucket: int | None = None,
             chunk: int | None = None) -> str:
        """This tuner's canonical name for one region — every region this
        class declares or routes to goes through here, so the mesh-shape
        axis applies uniformly."""
        return region_key(kind, bucket, chunk=chunk,
                          mesh_shape=self.mesh_shape)

    # -- prefill region (chunked prefill) ------------------------------------
    def add_prefill(self, make_prefill: Callable[..., Callable],
                    chunk_sizes=(64,), buckets=LENGTH_BUCKETS,
                    block_qs=(64, 128), block_ks=(256, 512)) -> None:
        """Declare the prefill tuning region family.

        One ``dynamic select`` per (prompt-length bucket × chunk size);
        alternatives are built by ``make_prefill(block_q, block_k)`` —
        the (bucket × chunk × block_q × block_k) product space of the
        ``flash_paged_prefill`` kernel.  Winners commit per region and
        persist in the session's record store next to the decode winners.
        """
        self.prefill_buckets = tuple(buckets)
        self.prefill_param_names = ("block_q", "block_k")
        self.prefill_variants = [(bq, bk) for bq in block_qs
                                 for bk in block_ks]
        names = []
        for b in buckets:
            for cs in chunk_sizes:
                name = self._key("prefill", b, cs)
                sel = self.session.autotune("dynamic", "select", name=name)
                for var in self.prefill_variants:
                    label = ",".join(
                        f"{k}={v}"
                        for k, v in zip(self.prefill_param_names, var))
                    sel.alternative(name=label)(make_prefill(*var))
                self.prefill_regions[(b, cs)] = sel.region
                names.append(name)
        self.session.run("dynamic", names)

    # -- speculative region (draft + verify) ---------------------------------
    def add_spec(self, make_verify: Callable[..., Callable],
                 ks=(4,), buckets=LENGTH_BUCKETS,
                 block_qs=(8,), block_ks=(256,),
                 according: str | None = "min (time_per_token)") -> None:
        """Declare the speculative-verify tuning region family.

        One ``SpecBucket_{b}`` ``dynamic select`` per sequence-length
        bucket; alternatives are built by ``make_verify(k, block_q,
        block_k)`` — the (k × verify tile) product space.  A variant's k
        may be smaller than the engine's drafting width: it verifies (and
        can accept) only the first k drafts, which is exactly the
        accept-window policy the region is tuning.

        Raw per-call latency would degenerately prefer the smallest k
        (narrower verify chunk, fewer tokens out), so the default
        ``according`` criterion commits on ``time_per_token`` instead —
        variants report their measured call time divided by the tokens
        the accept rule emits (the paper's ``min (eps)`` form with a
        throughput-normalised eps).  Variants that return a plain value
        fall back to wall-clock.  Winners commit per bucket and persist
        in the session's record store next to the decode and prefill
        winners (warm restart = zero re-tuning).
        """
        self.spec_buckets = tuple(buckets)
        self.spec_param_names = ("k", "block_q", "block_k")
        self.spec_variants = [(k, bq, bk) for k in ks for bq in block_qs
                              for bk in block_ks]
        names = []
        for b in buckets:
            name = self._key("spec", b)
            sel = self.session.autotune("dynamic", "select", name=name,
                                        according=according)
            for var in self.spec_variants:
                label = ",".join(f"{k}={v}"
                                 for k, v in zip(self.spec_param_names, var))
                sel.alternative(name=label)(make_verify(*var))
            self.spec_regions[b] = sel.region
            names.append(name)
        self.session.run("dynamic", names)

    # -- kv-precision region (quantized paged KV) ----------------------------
    def add_kv_precision(self, make_variant: Callable[..., Callable],
                         precisions=("fp", "int8"), block_ks=(256,),
                         buckets=LENGTH_BUCKETS,
                         agreement_floor: float = 0.95) -> None:
        """Declare the KV-precision tuning region family.

        One ``KVPrecision_{b}`` ``dynamic select`` per sequence-length
        bucket; alternatives are built by ``make_variant(bucket,
        kv_dtype, block_k)`` — the (pool precision × dequant tile)
        product.  ``fp`` candidates keep full-precision pages; ``int8``
        candidates store int8 pages with per-row fp32 scales and
        dequantize inside the attention kernel.

        Quantization is *lossy*, so raw latency is the wrong criterion: a
        fast candidate that corrupts the pages would still win.  Each
        variant therefore reports ``{"time_per_token", "agreement"}`` —
        agreement being the fraction of greedily decoded tokens matching
        the fp reference on the calibration prompt — and the region
        commits per ``min (time_per_token) .and. condition (agreement >=
        floor)``: the fastest candidate *among those above the quality
        floor*.  fp candidates agree with themselves by construction
        (agreement 1.0), so the guarded pool is never empty.  Winners
        persist in the session's record store and warm-load like every
        other region (restart = zero re-tuning, no re-calibration).

        ``precisions`` lists fp first so the first measured candidate
        establishes the reference output for the bucket.
        """
        self.kv_buckets = tuple(buckets)
        self.kv_param_names = ("kv_dtype", "block_k")
        self.kv_variants = [(pr, bk) for pr in precisions for bk in block_ks]
        according = (f"min (time_per_token) .and. "
                     f"condition (agreement >= {agreement_floor})")
        names = []
        for b in buckets:
            name = self._key("kv_precision", b)
            sel = self.session.autotune("dynamic", "select", name=name,
                                        according=according)
            for var in self.kv_variants:
                label = ",".join(f"{k}={v}"
                                 for k, v in zip(self.kv_param_names, var))
                sel.alternative(name=label)(make_variant(b, *var))
            self.kv_regions[b] = sel.region
            names.append(name)
        self.session.run("dynamic", names)

    def kv_precision(self, kv_len: int, *args, **kwargs):
        """Route one calibration measurement through the bucket's
        KVPrecision region (measure-then-commit)."""
        b = length_bucket(kv_len, self.kv_buckets)
        return self.session.execute(self._key("kv_precision", b),
                                    *args, **kwargs)

    def kv_precision_committed(self, kv_len: int) -> bool:
        """Has this bucket's KVPrecision region committed a winner?"""
        b = length_bucket(kv_len, self.kv_buckets)
        st = self.ctx.dynamic_state.get(self._key("kv_precision", b))
        return st is not None and st.committed is not None

    def committed_kv_precision(self) -> dict[int, int | None]:
        return {b: self.ctx.dynamic_state[
                    self._key("kv_precision", b)].committed
                for b in self.kv_regions}

    def committed_kv_precision_params(self) -> dict[int, dict | None]:
        """Committed KV-precision winners as (kv_dtype, block_k)
        assignments per sequence-length bucket."""
        out: dict[int, dict | None] = {}
        for b, idx in self.committed_kv_precision().items():
            out[b] = None if idx is None \
                else dict(zip(self.kv_param_names, self.kv_variants[idx]))
        return out

    def resolve_kv_dtype(self, default: str = "fp") -> str:
        """Collapse the per-bucket winners into one pool dtype.

        The pool's precision is structural — it is fixed when the cache
        is built, before any request's length is known — so the
        per-bucket winners are resolved by majority vote among committed
        buckets.  Ties break toward ``int8`` (the capacity win is the
        point of quantizing); no committed buckets → ``default``.
        """
        votes: dict[str, int] = {}
        for params in self.committed_kv_precision_params().values():
            if params is not None:
                votes[params["kv_dtype"]] = votes.get(params["kv_dtype"],
                                                      0) + 1
        if not votes:
            return default
        best = max(votes.values())
        winners = {d for d, n in votes.items() if n == best}
        return "int8" if "int8" in winners else winners.pop()

    # -- prefix-policy region (prefix caching) -------------------------------
    def add_prefix_policy(self, make_policy: Callable[..., Callable],
                          min_matches=(1, 2), evictions=("lru", "fifo"),
                          according: str | None = "min (miss_fraction)"
                          ) -> None:
        """Declare the prefix-cache reuse-policy tuning region.

        One ``PrefixPolicy`` ``dynamic select`` whose alternatives are
        built by ``make_policy(min_match, eviction)`` — the (minimum
        match granularity × eviction strategy) product.  Each variant
        applies its knobs to the live cache and performs one admission
        match; outputs are bit-identical under every policy, so the
        region measures real admissions.  Raw call latency is
        meaningless here (a policy that never matches is the fastest
        call), so the default ``according`` commits on the variant whose
        admission left the smallest *fraction* of its prompt uncached —
        normalized so long- and short-prompt admissions are comparable.
        Like every serving region that measures live traffic (a
        SpecBucket candidate sees whatever acceptance its tick happens
        to offer), candidates here sample different admissions — in
        particular the index warms up across the measurement window, so
        treat the winner as a traffic-shape heuristic, not a controlled
        experiment.  The winner persists in the session's record store
        and warm-loads exactly like the decode/prefill/spec winners.
        """
        self.prefix_param_names = ("min_match", "eviction")
        self.prefix_variants = [(g, ev) for g in min_matches
                                for ev in evictions]
        sel = self.session.autotune("dynamic", "select",
                                    name=self._key("prefix"),
                                    according=according)
        for var in self.prefix_variants:
            label = ",".join(f"{k}={v}"
                             for k, v in zip(self.prefix_param_names, var))
            sel.alternative(name=label)(make_policy(*var))
        self.prefix_region = sel.region
        self.session.run("dynamic", [self._key("prefix")])

    # -- gateway-policy region (pipelined serving front-end) -----------------
    def add_gateway(self, max_inflights=(1, 2), admit_batches=(1, 4, 16),
                    according: str | None = "min (time_per_good_token)"
                    ) -> None:
        """Declare the gateway concurrency-policy tuning region.

        One ``GatewayPolicy`` ``dynamic select`` over the (pipeline depth
        × admission batch) product: ``max_inflight`` is how many ticks
        may be in flight on the device before the host blocks (1 = the
        synchronous loop, 2 = double-buffered), ``admit_batch`` how many
        queued arrivals the gateway moves into the scheduler per tick.
        Pure policy again — greedy outputs are bit-identical under every
        candidate — but unlike the kernel regions a candidate cannot be
        measured by one call: the gateway runs a *window* of traffic
        (``policy_window`` finished requests) under each candidate's
        knobs and reports the window's aggregate through
        :meth:`gateway_policy`.  Raw latency is the wrong criterion (an
        admission policy that starves the queue makes individual calls
        fast), so the default ``according`` commits on
        ``time_per_good_token`` — wall seconds per token generated by
        requests that met their SLO; minimising it is maximising
        goodput.  The winner persists in the record store and
        warm-loads like every other region: a restarted gateway applies
        the committed knobs immediately and runs zero measurement
        windows.
        """
        self.gateway_param_names = ("max_inflight", "admit_batch")
        self.gateway_variants = [(mi, ab) for mi in max_inflights
                                 for ab in admit_batches]
        sel = self.session.autotune("dynamic", "select",
                                    name=self._key("gateway"),
                                    according=according)
        for var in self.gateway_variants:
            label = ",".join(f"{k}={v}"
                             for k, v in zip(self.gateway_param_names, var))
            mi, ab = var

            def report(stats: dict, _mi=mi, _ab=ab) -> dict:
                # the window already ran under these knobs; attribute its
                # aggregate to this candidate as the region's env
                return {**stats, "max_inflight": _mi, "admit_batch": _ab}

            sel.alternative(name=label)(report)
        self.gateway_region = sel.region
        self.session.run("dynamic", [self._key("gateway")])

    def gateway_policy(self, stats: dict, **kwargs):
        """Report one measurement window's aggregate stats through the
        GatewayPolicy region (measure-then-commit; the committed path is
        a no-op passthrough)."""
        return self.session.execute(self._key("gateway"), stats, **kwargs)

    def gateway_candidate(self) -> int:
        """The candidate index whose knobs the gateway should apply for
        the *next* window: the committed winner if any, else the next
        untried index — the same iteration order ``execute`` uses, so
        window stats are attributed to the knobs that produced them."""
        st = self.ctx.dynamic_state.get(self._key("gateway"))
        if st is None:
            return 0
        if st.committed is not None:
            return st.committed
        nxt = next((i for i in range(len(self.gateway_variants))
                    if i not in st.tried), None)
        return 0 if nxt is None else nxt

    def committed_gateway(self) -> int | None:
        st = self.ctx.dynamic_state.get(self._key("gateway"))
        return None if st is None else st.committed

    def committed_gateway_params(self) -> dict | None:
        """The committed GatewayPolicy winner as a (max_inflight,
        admit_batch) assignment (None while still measuring)."""
        idx = self.committed_gateway()
        return None if idx is None \
            else dict(zip(self.gateway_param_names,
                          self.gateway_variants[idx]))

    def decode(self, kv_len: int, *args, **kwargs):
        b = length_bucket(kv_len, self.buckets)
        return self.session.execute(self._key("decode", b), *args, **kwargs)

    def prefix_policy(self, *args, **kwargs):
        """Route one admission's prefix match through the PrefixPolicy
        region (measure-then-commit, like every dynamic select)."""
        return self.session.execute(self._key("prefix"), *args, **kwargs)

    def spec(self, kv_len: int, *args, **kwargs):
        """Route one speculative verify through its bucket's region."""
        b = length_bucket(kv_len, self.spec_buckets)
        return self.session.execute(self._key("spec", b), *args, **kwargs)

    def spec_committed(self, kv_len: int) -> bool:
        """Has this bucket's SpecBucket region committed a winner?  The
        engine uses this to stop paying per-call measurement overhead
        (device sync + host-side acceptance proxy) once tuning is done."""
        b = length_bucket(kv_len, self.spec_buckets)
        st = self.ctx.dynamic_state.get(self._key("spec", b))
        return st is not None and st.committed is not None

    def spec_draft_k(self, kv_len: int, default: int) -> int:
        """How many tokens are worth drafting for this bucket: the
        committed variant's accept window k, or ``default`` while the
        bucket is still measuring (every candidate, including the widest,
        must stay measurable).  Lets the engine stop paying draft-decode
        steps for tokens the committed verify would never accept."""
        b = length_bucket(kv_len, self.spec_buckets)
        st = self.ctx.dynamic_state.get(self._key("spec", b))
        if st is None or st.committed is None:
            return default
        return min(default, self.spec_variants[st.committed][0])

    def prefill(self, prompt_len: int, chunk_size: int, *args, **kwargs):
        """Route one prefill chunk through its (bucket × chunk) region."""
        b = length_bucket(prompt_len, self.prefill_buckets)
        return self.session.execute(self._key("prefill", b, chunk_size),
                                    *args, **kwargs)

    def committed(self) -> dict[int, int | None]:
        return {b: self.ctx.dynamic_state[self._key("decode", b)].committed
                for b in self.buckets}

    def committed_params(self) -> dict[int, dict | None]:
        """Committed winners decoded into PP assignments per bucket."""
        out: dict[int, dict | None] = {}
        for b, idx in self.committed().items():
            out[b] = None if idx is None \
                else dict(zip(self.param_names, self.variants[idx]))
        return out

    def committed_prefill(self) -> dict[tuple[int, int], int | None]:
        return {key: self.ctx.dynamic_state[
                    self._key("prefill", key[0], key[1])].committed
                for key in self.prefill_regions}

    def committed_prefill_params(self) -> dict[tuple[int, int], dict | None]:
        """Committed prefill winners as PP assignments per
        (prompt bucket, chunk size)."""
        out: dict[tuple[int, int], dict | None] = {}
        for key, idx in self.committed_prefill().items():
            out[key] = None if idx is None \
                else dict(zip(self.prefill_param_names,
                              self.prefill_variants[idx]))
        return out

    def committed_spec(self) -> dict[int, int | None]:
        return {b: self.ctx.dynamic_state[self._key("spec", b)].committed
                for b in self.spec_regions}

    def committed_spec_params(self) -> dict[int, dict | None]:
        """Committed speculative winners as (k, block_q, block_k)
        assignments per sequence-length bucket."""
        out: dict[int, dict | None] = {}
        for b, idx in self.committed_spec().items():
            out[b] = None if idx is None \
                else dict(zip(self.spec_param_names, self.spec_variants[idx]))
        return out

    def committed_prefix(self) -> int | None:
        st = self.ctx.dynamic_state.get(self._key("prefix"))
        return None if st is None else st.committed

    def committed_prefix_params(self) -> dict | None:
        """The committed PrefixPolicy winner as a (min_match, eviction)
        assignment (None while still measuring)."""
        idx = self.committed_prefix()
        return None if idx is None \
            else dict(zip(self.prefix_param_names,
                          self.prefix_variants[idx]))
