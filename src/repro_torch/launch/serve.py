"""Serve entry point of the port: the serving engine on synthetic requests.

Builds the arch with random weights from ``--seed`` on ``--device``
(default ``cuda``; it raises without a card), submits ``--requests``
synthetic prompts, runs the engine to completion and reports throughput
and latency percentiles.  ``--full`` serves the published widths of the
arch; ``--reduced`` (the default, as in the JAX package's serve) serves the
small test config.  ``--cache paged`` serves from the paged KV pool
(``--pages``, ``--page-size``), and ``--prefill-chunk N`` streams prompts
into it N tokens per tick.  ``--kv-dtype int8`` stores the pool's pages
as int8 with per-row float32 scales, and ``--num-splits N`` splits each
paged decode and verify step's page walk into N parallel segments
(split-KV).  ``--draft`` decodes speculatively (paged only): a draft made
of the target's leading half of layers proposes ``--spec-k`` tokens per
tick and the target verifies them in one chunk.  ``--prefix-cache``
(paged + chunked prefill) seeds admissions with indexed pages of earlier
prompts, and ``--shared-prefix N`` puts one common N-token system prompt
in front of every request.  ``--arch moonshot-v1-16b-a3b`` serves the
MoE stack (64 experts top-6 + 2 shared) through every path above; at
``--full`` its bf16 weights take 57.8 GB.  ``--arch falcon-mamba-7b``
serves the Mamba-1 stack from dense lanes that hold its recurrent
state, ``--arch zamba2-7b`` the Mamba-2 stack with its shared block's
sliding-window rings, ``--arch h2o-danube-1.8b`` its rings alone; the
paged pool, and with it ``--cache paged``, ``--draft`` and
``--prefix-cache``, does not apply to them and raises.  ``--arch
pixtral-12b`` serves mistral-nemo's decoder (D 160, G 4) text-only
through every path above, as the JAX package's serve does: a request
carries no patches (its vision stub runs through
``Model.prefill(frontend_embeds=...)``); at ``--full`` its bf16 weights
take 25.6 GB.  whisper-tiny is
not served: its prefill needs the encoder's frames, which a request does
not carry (the engine raises, as the JAX package serves it no frames
either); it runs through ``Model.prefill(frontend_embeds=...)`` and
``Model.decode_step``.  ``--gateway`` serves the same prompts
through the async HTTP/SSE gateway (:mod:`repro_torch.serving.gateway`)
on ``--port`` (0: any free port) of 127.0.0.1: one real TCP client per
request streams its tokens, a client bounced with 429 (more than
``--queue-limit`` waiting) retries after ``Retry-After``, and the report
gains the pipeline's counters and goodput under the ``--slo-ttft`` and
``--slo-itl`` SLOs.

``--autotune`` serves through run-time AT (:mod:`repro_torch.tuning.dynamic`,
sessions of :mod:`repro_torch.at` in ``--workdir``): each decode step
through its length bucket's ``DecodeBucket`` region over the decode
kernel's key tiles (x ``num_splits`` 1, 2, 4 on the paged pool, pinned by
``--num-splits``), each prefill chunk through ``PrefillBucket`` over the
prefill kernel's (block_q x block_k) tiles, each verify through
``SpecBucket`` (window k x verify tile), each prefix-cache admission
through ``PrefixPolicy`` and, with ``--gateway``, the pipeline's knobs
through ``GatewayPolicy`` windows of ``--policy-window`` requests.  A
region measures each candidate once (a candidate waits for the device
while its region measures) and commits the fastest; the winners persist
in the workdir's record file (``--tuning-backend``, over a read-only
``--golden-db``), so a second serve in the same workdir makes no
measurement.  ``--kv-dtype auto`` (paged, with ``--autotune``) calibrates
fp against int8 pages per bucket under a greedy-agreement floor and
builds the pool in the majority winner.  ``python -m repro_torch.at list
--workdir DIR`` lists what a workdir has tuned.

``--mesh RxC`` serves tensor-parallel (paged only): the command starts a
world of R x C ranks itself (:func:`repro_torch.distributed.run_world`:
NCCL when every rank has a card of its own, else gloo, several ranks
then sharing one card or the CPU), each rank serves with the weights
whole and its slice of the KV heads (``ServingEngine(mesh=...)``), and
rank 0 prints the report, its ``"mesh"`` and ``"outputs"`` (greedy
tokens by request) as the JAX serve's.  ``"1x1"`` starts no world and is
the unsharded serve exactly.  With ``--autotune`` a multi-rank mesh keys
its regions ``..._mesh{R}x{C}`` and rank 0 decides every commit.  With
``--gateway`` rank 0 runs the gateway, its clients and its policy, and
broadcasts each tick's admissions and cancellations to the other ranks,
which follow it tick for tick (:meth:`PipelinedEngine.follow`).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --full --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --kv-dtype int8 --num-splits 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --draft --spec-k 4 --num-splits 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --prefix-cache --shared-prefix 256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --full --max-len 4700 --prompt-len 4600
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --gateway
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --cache paged --prefill-chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        moonshot-v1-16b-a3b --full --cache paged --prefill-chunk 128
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
        --full --cache paged --prefill-chunk 128 --kv-dtype int8 \
        --num-splits 8
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --autotune --workdir /tmp/at   # twice: warm
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --mesh 1x2     # two ranks sharing the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --cache paged --prefill-chunk 8 --mesh 1x2
    PYTHONPATH=src python -m repro_torch.launch.serve --full --cache paged \
        --prefill-chunk 128 --gateway --mesh 1x2
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import dataclasses
import functools
import time

import numpy as np
import torch

from .. import at
from ..configs import get_arch
from ..core.executor import _block
from ..device import resolve
from ..distributed.collectives import all_reduce
from ..distributed.process_mesh import run_world
from ..distributed.sharding import make_serving_mesh, parse_mesh_spec
from ..kernels import build
from ..kernels import paged_attention as pa
from ..kernels.ops import mesh_model_axis
from ..models import build_model
from ..models.transformer import torch_dtype
from ..serving import REDUCED_BUCKETS, Request, SamplingParams, ServingEngine
from ..serving.compiled import compile_step
from ..serving.gateway import GatewayServer, PipelinedEngine, sse_generate
from ..serving.gateway.pipeline import goodput_stats
from ..tuning.ranks import mesh_session, sync_committed


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serve run shape as one typed object (the fields of the JAX
    package's ``ServeConfig``, plus ``reduced`` and ``device``).
    ``mesh`` is the tensor-parallel mesh spec (``"RxC"``, data x model,
    e.g. ``"1x2"``; None: unsharded)."""

    arch: str = "yi-6b"
    n_requests: int = 8
    n_lanes: int = 4
    max_len: int = 96
    prompt_len: int = 16
    max_new: int = 12
    seed: int = 0
    cache: str = "dense"
    n_pages: int | None = None
    page_size: int = 16
    timeslice: int | None = None
    prefill_chunk: int | None = None
    kv_dtype: str = "fp"
    num_splits: int | None = None
    draft: bool = False
    spec_k: int = 4
    prefix_cache: bool = False
    shared_prefix: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    gateway: bool = False
    port: int = 0
    queue_limit: int = 64
    slo_ttft_s: float = 30.0
    slo_itl_s: float = 5.0
    policy_window: int = 2
    autotune: bool = False
    workdir: str = "."
    tuning_backend: str = "jsonl"
    golden_db: str | None = None
    reduced: bool = True
    device: str = "cuda"
    mesh: str | None = None

    #: argparse dest -> field, for the names that differ
    _ARG_FIELDS = {"requests": "n_requests", "lanes": "n_lanes",
                   "pages": "n_pages", "slo_ttft": "slo_ttft_s",
                   "slo_itl": "slo_itl_s"}

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ServeConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for dest, value in vars(args).items():
            name = cls._ARG_FIELDS.get(dest, dest)
            if name in fields:
                kw[name] = value
        return cls(**kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Waits:
    """Makes the serve's tuning variants wait for the device while their
    region measures, and not once it has committed.

    ``ATContext`` times a candidate with the host clock from call to
    return, and an eager CUDA step returns as soon as its kernels are
    queued: a variant whose region is still measuring synchronises the
    devices of its result (``core.executor._block``) before it returns.
    A variant finds its region by identity among the alternatives of the
    tuner's regions.  ``count`` holds the waits by region."""

    def __init__(self):
        self.tuner = None
        self.count: collections.Counter = collections.Counter()
        self._region_of: dict = {}

    def measuring(self, variant) -> str | None:
        """The name of ``variant``'s region if it is measuring, else None."""
        name = self._region_of.get(variant)
        if name is None:
            t = self.tuner
            for region in (*t.regions.values(), *t.prefill_regions.values(),
                           *t.spec_regions.values()):
                for sub in region.subregions:
                    self._region_of[sub.fn] = region.name
            name = self._region_of[variant]
        st = self.tuner.ctx.dynamic_state.get(name)
        return name if st is not None and st.committed is None else None

    def __call__(self, variant, out, measuring: bool | None = None):
        """``out``, after the wait if ``variant``'s region measures (the
        caller's ``measuring``, where it knows)."""
        name = self.measuring(variant)
        if measuring is None:
            measuring = name is not None
        if measuring:
            _block(out)
            self.count[name] += 1
        return out


def _variant(waits: _Waits, step, kernel: str, **tiles):
    """A tuning alternative: publish ``tiles`` to ``kernel`` (what
    ``kernels.ops`` reads on the kernel route), run ``step``, and wait for
    the device while the region measures."""
    def variant(*args):
        at.publish(kernel, **tiles)
        return waits(variant, step(*args))
    return variant


def _make_kv_precision_bench(model, page_size: int, device: torch.device,
                             lanes: int = 2, decode_steps: int = 3,
                             steps: list | None = None):
    """The calibration bench of the ``KVPrecision`` regions, as the JAX
    serve's: ``make_variant(bucket, kv_dtype, block_k)`` builds one
    candidate, a throwaway paged pool of that precision, one prefill of a
    synthetic prompt (at most 4 pages, drawn from the bucket) and a few
    greedy decode steps at ``block_k``, timed end to end (each step's
    token comes to the host, so the time includes the device's).  It
    reports ``time_per_token`` and ``agreement``, the share of its greedy
    tokens equal to the fp candidate's for the bucket (fp: 1.0).  Its
    prefill and decode are compiled once for every candidate, as the JAX
    serve jits them once (each published ``block_k`` keys its own
    graphs), and appended to ``steps``; a pool is made once a (prompt
    length, precision), so that its graphs replay."""
    ref_tokens: dict[int, list] = {}
    prefill = compile_step(model.paged_prefill_step, "kv_bench_prefill")
    decode = compile_step(model.paged_decode_step, "kv_bench_decode")
    if steps is not None:
        steps += [prefill, decode]
    pools: dict[tuple, dict] = {}

    def run(bucket, kv_dtype, block_k, params):
        plen = min(bucket, 4 * page_size)
        blocks = -(-(plen + decode_steps) // page_size)
        caches = pools.get((plen, kv_dtype))
        if caches is None:
            caches = pools[plen, kv_dtype] = model.init_paged_caches(
                lanes * blocks + 1, page_size, device,
                quantized=kv_dtype == "int8")
        table = torch.from_numpy(
            (np.arange(lanes)[:, None] * blocks + np.arange(blocks)[None, :]
             + 1).astype(np.int32)).to(device)
        rng = np.random.default_rng(bucket)
        prompt = torch.from_numpy(np.tile(
            rng.integers(0, model.cfg.vocab_size, size=plen),
            (lanes, 1))).to(device)
        start = torch.zeros((lanes,), dtype=torch.long, device=device)
        kv_len = torch.full((lanes,), plen, dtype=torch.long, device=device)
        at.publish("flash_paged_decode", block_k=block_k)
        at.publish("flash_paged_prefill", block_k=block_k)
        t0 = time.perf_counter()
        logits, _ = prefill(params, caches, table, prompt, start, kv_len,
                            kv_len - 1)
        tok = logits.argmax(-1)
        toks = [int(tok[0])]
        pos = kv_len
        for _ in range(decode_steps):
            logits, _ = decode(params, caches, table, tok[:, None], pos)
            tok = logits.argmax(-1)
            toks.append(int(tok[0]))
            pos = pos + 1
        return toks, (time.perf_counter() - t0) / (1 + decode_steps)

    def make_variant(bucket, kv_dtype, block_k):
        def variant(params, bucket=bucket, kv_dtype=kv_dtype,
                    block_k=block_k):
            toks, tpt = run(bucket, kv_dtype, block_k, params)
            if kv_dtype == "fp":
                ref_tokens.setdefault(bucket, toks)
                agreement = 1.0
            else:
                if bucket not in ref_tokens:   # int8 measured first
                    ref_tokens[bucket], _ = run(bucket, "fp", block_k,
                                                params)
                ref = ref_tokens[bucket]
                agreement = sum(a == r for a, r in zip(toks, ref)) \
                    / max(len(ref), 1)
            return {"kv_dtype": kv_dtype, "block_k": block_k,
                    "time_per_token": tpt, "agreement": agreement}
        return variant

    return make_variant


def tile_ladders(model, page_size: int) -> dict[str, tuple]:
    """The run-time AT's candidate tiles for ``model``'s query type, head
    dim and group size: the instances of the decode and prefill kernels
    (``kernels.paged_attention.decode_block_ks`` and ``prefill_tiles``),
    the paged ones cut to whole pages (``tuning.page_block_ks``)."""
    from ..tuning import page_block_ks
    cfg = model.cfg
    dtype = torch_dtype(cfg.compute_dtype)
    dense_ks = pa.decode_block_ks(dtype, cfg.head_dim, dense=True)
    block_qs, prefill_ks = pa.prefill_tiles(dtype, cfg.head_dim,
                                            cfg.n_heads // cfg.n_kv_heads)
    decode_ks = page_block_ks(page_size, pa.decode_block_ks(dtype,
                                                            cfg.head_dim))
    prefill_ks = page_block_ks(page_size, prefill_ks)
    return {"dense_block_k": dense_ks, "block_k": decode_ks,
            "block_q": block_qs, "prefill_block_k": prefill_ks,
            # the calibration bench publishes one tile to both kernels
            "kv_block_k": tuple(bk for bk in decode_ks if bk in prefill_ks)
            or decode_ks[:1]}


def make_autotuner(model, scfg: ServeConfig, mesh=None):
    """The serve's ``DecodeAutoTuner`` (a ``repro_torch.at`` session in
    ``scfg.workdir``) with the JAX serve's region families over the port's
    tile ladders (:func:`tile_ladders`): ``DecodeBucket`` (block_k x
    num_splits 1, 2, 4 on the paged pool, ``scfg.num_splits`` pinning the
    splits; block_k alone on dense lanes), ``PrefillBucket`` at the
    engine's chunk (block_q x block_k), ``SpecBucket`` (k in 1, k/2, k x
    the smallest verify block_q that holds k + 1 positions x block_k),
    ``KVPrecision`` (fp, int8 x block_k) for ``--kv-dtype auto``,
    ``PrefixPolicy`` (min match 1, 2 x lru, fifo) and ``GatewayPolicy``
    (max_inflight 1, 2 x admit_batch 2, 8).  Its ``waits`` count the
    measured calls that waited for the device, by region.

    Under a ``mesh`` of more than one rank the variants bind the mesh
    (they run the engine's sharded steps; the ``KVPrecision`` bench stays
    unsharded, as the JAX serve's), the regions are keyed ``_mesh{R}x{C}``
    and rank 0 decides every commit (:mod:`repro_torch.tuning.ranks`)."""
    from ..tuning import DecodeAutoTuner
    session = mesh_session(scfg.workdir, mesh,
                           record_backend=scfg.tuning_backend,
                           golden_db=scfg.golden_db)
    waits = _Waits()
    tiles = tile_ladders(model, scfg.page_size)
    steps: list = []          # the variants' compiled steps

    def compiled(fn, name: str):
        """A candidate's own compiled step, as the JAX serve jits each
        (eager under a sharded mesh, as the engine's steps)."""
        if mesh_model_axis(mesh) > 1:
            return fn
        steps.append(compile_step(fn, name))
        return steps[-1]

    if scfg.cache != "paged":
        tuner = DecodeAutoTuner(
            session, lambda bk: _variant(waits,
                                         compiled(model.decode_step,
                                                  "decode"),
                                         "flash_decode", block_k=bk),
            buckets=REDUCED_BUCKETS, block_ks=tiles["dense_block_k"],
            mesh_shape=scfg.mesh)
    else:
        splits = ((1, 2, 4) if scfg.num_splits is None
                  else (int(scfg.num_splits),))
        tuner = DecodeAutoTuner(
            session, lambda bk, ns: _variant(
                waits, compiled(functools.partial(model.paged_decode_step,
                                                  mesh=mesh), "decode"),
                "flash_paged_decode", block_k=bk, num_splits=ns),
            buckets=REDUCED_BUCKETS, block_ks=tiles["block_k"],
            num_splits=splits, mesh_shape=scfg.mesh)
        if scfg.prefill_chunk is not None:
            tuner.add_prefill(
                lambda bq, bk: _variant(
                    waits, compiled(functools.partial(
                        model.paged_prefill_step, mesh=mesh),
                        "prefill_step"),
                    "flash_paged_prefill", block_q=bq, block_k=bk),
                chunk_sizes=(scfg.prefill_chunk,), buckets=REDUCED_BUCKETS,
                block_qs=tiles["block_q"], block_ks=tiles["prefill_block_k"])
        if scfg.draft:
            k = scfg.spec_k
            verify_q = min((bq for bq in tiles["block_q"] if bq >= k + 1),
                           default=max(tiles["block_q"]))

            def make_verify(k, block_q, block_k):
                verify = compiled(functools.partial(
                    model.speculative_step, num_splits=scfg.num_splits,
                    mesh=mesh), "verify")

                def variant(p, caches, table, tokens, start, kv_len,
                            measure=True):
                    at.publish("flash_paged_verify", block_q=block_q,
                               block_k=block_k)
                    t0 = time.perf_counter()
                    logits, caches = waits(variant, verify(
                        p, caches, table, tokens[:, :k + 1], start,
                        torch.minimum(kv_len, start + k + 1)),
                        measuring=measure)
                    if not measure:
                        return logits, caches
                    dt = time.perf_counter() - t0
                    # the greedy accept proxy over the live lanes: leading
                    # draft/argmax matches + 1 = tokens the window emits
                    am = logits[:, :-1].argmax(-1).cpu().numpy()
                    dr = tokens[:, 1:k + 1].cpu().numpy()
                    st, kl = start.cpu().numpy(), kv_len.cpu().numpy()
                    emitted = 0
                    for b in range(dr.shape[0]):
                        if kl[b] <= st[b]:
                            continue
                        w, a = min(k, int(kl[b] - st[b]) - 1), 0
                        while a < w and dr[b, a] == am[b, a]:
                            a += 1
                        emitted += a + 1
                    return {"logits": logits, "caches": caches,
                            "time_per_token": dt / max(emitted, 1)}
                return variant

            tuner.add_spec(make_verify,
                           ks=tuple(sorted({1, max(1, k // 2), k})),
                           buckets=REDUCED_BUCKETS, block_qs=(verify_q,),
                           block_ks=tiles["prefill_block_k"])
        if scfg.prefix_cache:
            def make_policy(min_match, eviction):
                def variant(kv, lane_id, prompt):
                    kv.set_prefix_policy(min_match=min_match,
                                         eviction=eviction)
                    cached = kv.seed_prefix(lane_id, prompt)
                    return {"cached": cached, "miss_fraction":
                            (len(prompt) - cached) / max(len(prompt), 1)}
                return variant

            tuner.add_prefix_policy(make_policy)
        if scfg.kv_dtype == "auto":
            tuner.add_kv_precision(
                _make_kv_precision_bench(model, scfg.page_size,
                                         resolve(scfg.device), steps=steps),
                block_ks=tiles["kv_block_k"], buckets=REDUCED_BUCKETS)
    if scfg.gateway:
        tuner.add_gateway(max_inflights=(1, 2), admit_batches=(2, 8))
    sync_committed(tuner, mesh)
    waits.tuner = tuner
    tuner.waits = waits
    tuner.compiled_steps = steps
    return tuner


def weights_checksum(params: dict) -> float:
    """The float64 sum of every weight (the same seed must give the same
    weights on every rank)."""
    leaves, stack = [], [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            leaves.append(node)
    return float(sum(t.double().sum() for t in leaves))


def check_same_weights(params: dict, mesh) -> None:
    """Raise unless every rank of ``mesh``'s world holds the same weights
    (their checksums' max and min, from one all-reduce, are equal)."""
    c = weights_checksum(params)
    both = all_reduce(torch.tensor([c, -c], dtype=torch.float64,
                                   device=params["embed"].device),
                      op=torch.distributed.ReduceOp.MAX)
    if float(both[0]) != -float(both[1]):
        raise RuntimeError(
            f"the ranks' weights differ: checksums from {-float(both[1])!r} "
            f"to {float(both[0])!r} (rank {mesh.rank}: {c!r})")


def serve(**kwargs) -> dict:
    """Back-compat wrapper, as in the JAX package: build a
    :class:`ServeConfig` from keyword arguments and delegate to
    :func:`serve_config`."""
    return serve_config(ServeConfig(**kwargs))


def serve_config(scfg: ServeConfig) -> dict:
    """Serve ``scfg.n_requests`` synthetic requests; returns the report.
    A multi-rank ``scfg.mesh`` needs a world of its size: one call a rank
    inside :func:`repro_torch.distributed.run_world` (as
    :func:`serve_mesh` makes)."""
    if scfg.kv_dtype not in ("fp", "int8", "auto"):
        raise ValueError(f"unknown kv_dtype {scfg.kv_dtype!r}")
    if scfg.kv_dtype == "auto" and not (scfg.cache == "paged"
                                        and scfg.autotune):
        raise ValueError("--kv-dtype auto needs --cache paged --autotune")
    _check_mesh_flags(scfg)
    mesh = make_serving_mesh(scfg.mesh)
    dev = resolve(scfg.device)
    cfg = get_arch(scfg.arch)
    if scfg.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    if not (model.supports_paged_cache or cfg.is_encoder_decoder):
        state = " and ".join(
            what for what, has in (
                ("recurrent SSM state", cfg.ssm_version > 0),
                ("its sliding window's ring buffer", cfg.window is not None))
            if has)
        for flag, asked in (("--cache paged", scfg.cache == "paged"),
                            ("--draft", scfg.draft),
                            ("--prefix-cache", scfg.prefix_cache)):
            if asked:
                raise ValueError(
                    f"{flag} needs the paged KV pool, which arch "
                    f"{cfg.name!r} does not use: it keeps {state} in dense "
                    "lanes (serve it with --cache dense)")
    params = model.init(scfg.seed, dev)
    if mesh is not None and mesh.size > 1:
        check_same_weights(params, mesh)
    return serve_model(model, params, scfg, mesh)


def _check_mesh_flags(scfg: ServeConfig) -> None:
    dims = parse_mesh_spec(scfg.mesh)
    if dims is None or dims[0] * dims[1] == 1:
        return
    if scfg.cache != "paged":
        raise ValueError(
            "tensor-parallel serving shards the paged page pools; use "
            "--cache paged with --mesh")


def serve_mesh(scfg: ServeConfig, join_timeout_s: float = 3600.0) -> dict:
    """Serve ``scfg`` over its mesh: a world of R x C ranks
    (:func:`repro_torch.distributed.run_world`, every CUDA kernel built
    here first, so the ranks only load them), one :func:`serve_config` a
    rank; returns rank 0's report.  A 1-rank mesh serves in this process."""
    dims = parse_mesh_spec(scfg.mesh)
    n = 1 if dims is None else dims[0] * dims[1]
    if n == 1:
        return serve_config(scfg)
    _check_mesh_flags(scfg)
    if resolve(scfg.device).type == "cuda":
        build.build_all()
    return run_world(serve_config, n, device=scfg.device, args=(scfg,),
                     join_timeout_s=join_timeout_s)[0]


def serve_model(model, params: dict, scfg: ServeConfig, mesh=None,
                tuner=None) -> dict:
    """Serve ``scfg``'s requests with a built model and its weights: the
    run-time tuner (``scfg.autotune``) and ``--kv-dtype auto``'s
    calibration before the engine is built, then :func:`serve_engine`.
    ``mesh`` is this rank's serving mesh (:func:`make_serving_mesh`).
    ``tuner``, a run-time tuner built beforehand, is used in place of the
    :func:`make_autotuner` one that ``scfg.autotune`` asks for: through a
    tuner of a mesh's region names that binds no mesh, an unsharded serve
    reads the winners the mesh serve committed."""
    draft_model = draft_params = None
    if scfg.draft:
        # self-speculative draft: the target's leading layers (views) with
        # the embedding and head shared
        draft_model = model.draft_model()
        draft_params = model.slice_draft_params(params, draft_model)
    if tuner is None and scfg.autotune:
        tuner = make_autotuner(model, scfg, mesh)
    kv_dtype = scfg.kv_dtype
    if kv_dtype == "auto":
        # every (precision x block_k) candidate of every bucket, then one
        # pool dtype by majority (the pool is built once, up front); a
        # warm workdir finds every region committed and measures nothing
        for b in tuner.kv_buckets:
            while not tuner.kv_precision_committed(b):
                tuner.kv_precision(b, params)
        kv_dtype = tuner.resolve_kv_dtype()
    engine = ServingEngine(model, params, n_lanes=scfg.n_lanes,
                           max_len=scfg.max_len, cache=scfg.cache,
                           n_pages=scfg.n_pages, page_size=scfg.page_size,
                           timeslice=scfg.timeslice,
                           prefill_chunk=scfg.prefill_chunk,
                           draft_model=draft_model,
                           draft_params=draft_params,
                           spec_k=scfg.spec_k if scfg.draft else None,
                           prefix_cache=scfg.prefix_cache,
                           kv_dtype=kv_dtype, autotuner=tuner,
                           # split-KV applies to the paged decode and
                           # verify only, as in the JAX package's serve
                           num_splits=(scfg.num_splits
                                       if scfg.cache == "paged" else None),
                           mesh=mesh)
    return serve_engine(engine, scfg, mesh)


def autotune_report(tuner) -> dict:
    """What the run-time AT did: the session's measurements (0 on a warm
    restart), the regions that measured and those warm-loaded, each
    measured candidate's cost by region and the numbers it reported, the
    waits for the device by region, and the committed parameters of every
    family."""
    states = tuner.ctx.dynamic_state
    labels = {r.name: [sub.name for sub in r.subregions]
              for r in (*tuner.regions.values(),
                        *tuner.prefill_regions.values(),
                        *tuner.spec_regions.values(),
                        *tuner.kv_regions.values(), tuner.prefix_region,
                        tuner.gateway_region) if r is not None}
    return {
        "executor_calls": tuner.session.executor_calls,
        "measurements": sum(len(st.tried) for st in states.values()),
        "measured_regions": sorted(n for n, st in states.items()
                                   if st.tried),
        "warm_regions": sorted({n for _, n in tuner.session.warm_hits}),
        "costs": {n: {labels[n][i]: c for i, c in sorted(st.tried.items())}
                  for n, st in states.items() if st.tried and n in labels},
        # the numbers candidates reported where their region commits on a
        # metric (time_per_token, agreement, miss_fraction, goodput)
        "reported": {n: {labels[n][i]: {k: v for k, v in env.items()
                                        if isinstance(v, (int, float))}
                         for i, env in sorted(st.env_seen.items()) if env}
                     for n, st in states.items()
                     if n in labels and any(st.env_seen.values())},
        "waits": dict(getattr(tuner, "waits", _Waits()).count),
        "committed": {
            "decode": tuner.committed_params(),
            "prefill": ({f"{b}_c{cs}": pp for (b, cs), pp
                         in tuner.committed_prefill_params().items()}
                        if tuner.prefill_regions else None),
            "spec": (tuner.committed_spec_params()
                     if tuner.spec_regions else None),
            "kv_precision": (tuner.committed_kv_precision_params()
                             if tuner.kv_regions else None),
            "prefix": (tuner.committed_prefix_params()
                       if tuner.prefix_region is not None else None),
            "gateway": (tuner.committed_gateway_params()
                        if tuner.gateway_region is not None else None)},
    }


def draw_prompts(scfg: ServeConfig, vocab_size: int) -> list[list[int]]:
    """The synthetic prompts, drawn from ``scfg.seed``: the shared system
    prompt first, then each request's own tokens behind it."""
    rng = np.random.default_rng(scfg.seed)
    prefix = (rng.integers(0, vocab_size, size=scfg.shared_prefix)
              .tolist() if scfg.shared_prefix else [])
    return [prefix + rng.integers(
        0, vocab_size, size=rng.integers(4, scfg.prompt_len)).tolist()
        for _ in range(scfg.n_requests)]


def _serve_gateway(engine: ServingEngine, prompts: list[list[int]],
                   scfg: ServeConfig, mesh=None) -> tuple[dict, dict]:
    """Serve ``prompts`` through the HTTP/SSE gateway: every request is a
    real TCP client on 127.0.0.1 streaming SSE frames (a 429 bounce waits
    ``Retry-After`` and retries), the engine ticks in the pipelined
    asyncio loop.  Returns the tokens each client received, keyed by its
    prompt's index (the synchronous serve's rid), and the gateway report:
    the pipeline's counters, goodput under the SLOs, the retries, the
    count of the streams' final events by kind and the engine's tokens by
    the gateway's rids (``by_rid``).  On ranks 1.. of a multi-rank
    ``mesh`` the engine follows rank 0's gateway instead: no server and
    no clients, the outputs by rid, and the pipeline's counters."""
    pipe = PipelinedEngine(engine, queue_limit=scfg.queue_limit,
                           tuner=engine.autotuner,
                           policy_window=scfg.policy_window,
                           slo_ttft_s=scfg.slo_ttft_s,
                           slo_itl_s=scfg.slo_itl_s, mesh=mesh)
    if pipe.mesh is not None and pipe.mesh.rank != 0:
        t0 = time.monotonic()
        pipe.follow()
        by_rid = {int(r.rid): [int(t) for t in r.out_tokens]
                  for r in engine.finished}
        return by_rid, {"requests": len(prompts), "by_rid": by_rid,
                        "wall_s": time.monotonic() - t0,
                        **{k: v for k, v in pipe.stats().items()
                           if k != "draining"}}
    sampling = None
    if scfg.temperature > 0.0 or scfg.top_k or scfg.top_p < 1.0:
        sampling = {"temperature": scfg.temperature, "top_k": scfg.top_k,
                    "top_p": scfg.top_p}

    async def one(port: int, i: int, prompt: list[int]):
        tokens, bounced = [], 0
        while True:        # honor Retry-After on a 429 bounce
            final = None
            async for kind, payload in sse_generate(
                    "127.0.0.1", port, prompt, max_new_tokens=scfg.max_new,
                    sampling=(dict(sampling, seed=scfg.seed + i)
                              if sampling else None)):
                if kind == "tokens":
                    tokens.extend(payload)
                else:
                    final = (kind, payload)
            if final and final[0] == "http_error" \
                    and final[1]["status"] == 429:
                bounced += 1
                await asyncio.sleep(float(final[1]["retry_after"] or 1))
                continue
            return tokens, bounced, final

    async def run():
        srv = GatewayServer(pipe, port=scfg.port)
        await srv.start()
        t0 = time.monotonic()
        results = await asyncio.gather(
            *[one(srv.port, i, p) for i, p in enumerate(prompts)])
        wall = time.monotonic() - t0
        await srv.drain()
        return results, wall

    results, wall = asyncio.run(run())
    outputs = {i: tokens for i, (tokens, _, _) in enumerate(results)}
    report = {
        "by_rid": {int(r.rid): [int(t) for t in r.out_tokens]
                   for r in engine.finished},
        "requests": len(prompts),
        "wall_s": wall,
        "client_retries_429": sum(r[1] for r in results),
        "streams": dict(collections.Counter(
            r[2][0] if r[2] else "closed" for r in results)),
        **{k: v for k, v in pipe.stats().items() if k != "draining"},
        **goodput_stats(engine.finished, wall, scfg.slo_ttft_s,
                        scfg.slo_itl_s),
    }
    return outputs, report


def serve_engine(engine: ServingEngine, scfg: ServeConfig,
                 mesh=None) -> dict:
    """Submit the requests ``scfg`` describes to ``engine`` (through the
    gateway with ``scfg.gateway``), run them to the end and return the
    report.  ``mesh`` is this rank's serving mesh: over more than one
    rank, rank 0's gateway leads the others'."""
    prompts = draw_prompts(scfg, engine.model.cfg.vocab_size)
    gateway_report = None
    if scfg.gateway:
        outputs, gateway_report = _serve_gateway(engine, prompts, scfg,
                                                 mesh)
    else:
        for rid, prompt in enumerate(prompts):
            engine.submit(Request(rid=rid, prompt=prompt,
                                  max_new_tokens=scfg.max_new,
                                  sampling=SamplingParams(
                                      temperature=scfg.temperature,
                                      top_k=scfg.top_k, top_p=scfg.top_p,
                                      seed=scfg.seed + rid)))
        finished = engine.run(max_steps=scfg.n_requests
                              * (scfg.max_new + 4 + scfg.shared_prefix))
        outputs = {int(r.rid): [int(t) for t in r.out_tokens]
                   for r in finished}
    summary = engine.metrics.summary()
    prefix_stats = None
    if engine.kv.prefix_cache:
        kvp = engine.kv.stats()["prefix"]
        prefix_stats = {**summary["prefix_cache"],
                        **{k: kvp[k] for k in ("pages_saved", "cow_copies",
                                               "evictions", "cached_pages")}}
    return {
        "config": scfg.to_dict(),
        "device": (torch.cuda.get_device_name(engine.device)
                   if engine.device.type == "cuda" else "cpu"),
        "mesh": scfg.mesh,
        # rid -> greedy token ids: what the mesh-vs-unsharded checks compare
        "outputs": outputs,
        "finished": len(engine.finished), "requests": scfg.n_requests,
        "decode_steps": engine.steps,
        "prefill_chunks": engine.prefill_chunks,
        "generated_tokens": summary["generated_tokens"],
        "tokens_per_s": summary["tokens_per_s"],
        "p50_queue_wait_s": summary["queue_wait_s"]["p50"],
        "p99_queue_wait_s": summary["queue_wait_s"]["p99"],
        "mean_ttft_s": summary["ttft_s"]["mean"],
        "p50_ttft_s": summary["ttft_s"]["p50"],
        "p99_ttft_s": summary["ttft_s"]["p99"],
        "p50_itl_s": summary["itl_s"]["p50"],
        "p99_itl_s": summary["itl_s"]["p99"],
        "wall_s": summary["wall_s"],
        "preemptions": summary["preemptions"],
        "spec": engine.spec_stats() if engine.spec_k else None,
        "cache": engine.kv.stats(),
        "prefix_cache": prefix_stats,
        "kv_dtype": engine.kv.kv_dtype,
        "gateway": gateway_report,
        "autotune": (autotune_report(engine.autotuner)
                     if engine.autotuner is not None else None),
        "tuning_db": engine.tuning_db(),
        # the compiled steps' captures, replays and graphs (CUDA only)
        "graphs": engine.graph_stats(),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="prompts are drawn with lengths in [4, prompt_len)")
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", choices=("dense", "paged"), default="dense",
                    help="KV backend: per-lane strips or the paged pool")
    ap.add_argument("--pages", type=int, default=None,
                    help="paged pool size (default: every lane at max-len, "
                         "plus the null page)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--timeslice", type=int, default=None,
                    help="preempt a lane after N decode steps when work is "
                         "queued (serve more requests than lanes)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="stream prompts into the paged cache N tokens per "
                         "tick (needs --cache paged)")
    ap.add_argument("--kv-dtype", choices=("fp", "int8", "auto"),
                    default="fp",
                    help="paged pool storage: the cache dtype, int8 pages "
                         "with per-row float32 scales, or auto (the "
                         "KVPrecision regions calibrate fp against int8 "
                         "under a greedy-agreement floor; needs --autotune)")
    ap.add_argument("--num-splits", type=int, default=None,
                    help="split each paged decode and verify step's page "
                         "walk into N parallel segments (split-KV; paged "
                         "cache only)")
    ap.add_argument("--draft", action="store_true",
                    help="paged: speculative decoding with a self-"
                         "speculative draft (the target's leading layers)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per speculative tick")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="paged + chunked: seed admissions with the indexed "
                         "pages of earlier prompts (copy-on-write)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend one common N-token system prompt to every "
                         "request")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k sampling filter (0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 disables)")
    ap.add_argument("--gateway", action="store_true",
                    help="serve through the async HTTP/SSE gateway "
                         "(pipelined ticks, real localhost TCP clients)")
    ap.add_argument("--port", type=int, default=0,
                    help="gateway: listen port (0 = ephemeral)")
    ap.add_argument("--queue-limit", type=int, default=64,
                    help="gateway: admission-queue bound (429 beyond)")
    ap.add_argument("--slo-ttft", type=float, default=30.0,
                    help="gateway: TTFT SLO in seconds (goodput counts "
                         "only requests inside it)")
    ap.add_argument("--slo-itl", type=float, default=5.0,
                    help="gateway: p95 inter-token-latency SLO in seconds")
    ap.add_argument("--policy-window", type=int, default=2,
                    help="gateway: finished requests per GatewayPolicy "
                         "measurement window (with --autotune)")
    ap.add_argument("--autotune", action="store_true",
                    help="run-time AT over the decode, prefill, verify, "
                         "prefix and gateway regions (repro_torch.at)")
    ap.add_argument("--workdir", default=".",
                    help="AT session workdir (param files + record store)")
    ap.add_argument("--tuning-backend", default="jsonl",
                    help="tuning-DB backend under --workdir "
                         "(at.record_backends: jsonl | sqlite)")
    ap.add_argument("--golden-db", default=None,
                    help="read-only golden winner DB under the local store "
                         "(from 'python -m repro_torch.at export')")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="serve the reduced test config (default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="serve the arch at its published widths")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="tensor-parallel mesh 'RxC' (data x model ranks, "
                         "e.g. '1x2'; paged only): starts a world of R x C "
                         "ranks; '1x1' is the unsharded serve exactly")
    out = serve_mesh(ServeConfig.from_args(ap.parse_args(argv)))

    def fmt(x, spec):
        return format(x, spec) if x is not None else "n/a"

    print(f"[serve] {out['finished']}/{out['requests']} requests, "
          f"{out['generated_tokens']} tokens in {out['wall_s']:.2f}s "
          f"({out['tokens_per_s']:.1f} tok/s, "
          f"ttft p50 {fmt(out['p50_ttft_s'], '.4f')}s "
          f"p99 {fmt(out['p99_ttft_s'], '.4f')}s, "
          f"itl p50 {fmt(out['p50_itl_s'], '.4f')}s, "
          f"preemptions {out['preemptions']}, kv {out['kv_dtype']}) on "
          f"{out['device']}" + (f", mesh {out['mesh']}" if out["mesh"]
                                else ""))
    if out["spec"] is not None:
        print(f"[serve] speculative: {out['spec']}")
    if out["prefix_cache"] is not None:
        print(f"[serve] prefix cache: {out['prefix_cache']}")
    if out["autotune"] is not None:
        a = out["autotune"]
        print(f"[serve] autotune: {a['measurements']} measurements in "
              f"{len(a['measured_regions'])} regions, "
              f"{len(a['warm_regions'])} warm-loaded, committed "
              f"{a['committed']}, tuning db {out['tuning_db']}")
    if out["gateway"] is not None:
        g = out["gateway"]
        per_tick = {k: v / max(g["ticks"], 1)
                    for k, v in g["host_ms"].items()}
        print(f"[serve] gateway: {g['goodput_tok_s']:.1f} good tok/s (SLO "
              f"{g['slo_attainment']:.0%}), {g['overlapped_ticks']}/"
              f"{g['ticks']} ticks overlapped, {g['rejected_429']} bounced, "
              f"streams {g['streams']}, host ms a tick: schedule+dispatch "
              f"{per_tick['schedule_dispatch']:.2f}, wait "
              f"{per_tick['wait']:.2f}, emit {per_tick['emit']:.2f}")


if __name__ == "__main__":
    main()
