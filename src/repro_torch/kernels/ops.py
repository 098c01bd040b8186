"""Entry points of the kernels: kernel on CUDA, plain on CPU.

The model calls these, never the kernels directly.  A CUDA tensor goes
to the hand-written kernel, a CPU tensor to its plain PyTorch version;
``use_kernel=False`` asks for the plain version on either device (the
kernel-against-plain comparisons on the card use it), and
``use_kernel=True`` on CPU tensors raises instead of running anything
else.  The kernels read a contiguous layout, so the transposed q, k, v
the projections produce are made contiguous here, and the paged kernels'
int32 page tables and lengths are cast here.

On the kernel route the attention entry points read the tiles that
install-time and run-time AT publish (``at.tuned``), as the JAX
package's ``ops`` does: ``flash_attention`` (``block_q``, ``block_k``;
install-time, the ``FlashBlocks`` region), ``flash_decode``
(``block_k``), ``flash_paged_decode`` (``block_k``, ``num_splits``),
``flash_paged_prefill`` and ``flash_paged_verify`` (``block_q``,
``block_k``, ``num_splits``), each overridden by the caller's explicit
values; an explicit ``None`` is "not given" and leaves a published value
alone.  The plain versions ignore tiles, but for ``attention``'s chunked
route above ``CHUNKED_THRESHOLD`` (``chunked_attention``'s ``block_q``,
``block_k``).

Tensor parallelism (``mesh=``, a :class:`~repro_torch.distributed.Mesh`
whose ``"model"`` axis has more than one rank): ``paged_decode``,
``paged_prefill`` and ``paged_verify`` take q with every head and the
pools of this rank's KV-head slice; each rank runs its kernel on its
contiguous slice of q's heads (whole GQA groups, since both head counts
divide the axis) and the outputs are all-gathered over the model group in
head order, an exact copy, so the caller's output projection computes
what the unsharded engine does (the JAX package's ``_head_sharded``
under ``shard_map``).  The one-pass decode kernel sizes its cluster by
the unsharded KV-head count (``cluster_hkv``), so a rank launches the
unsharded math on its heads.  ``attention`` sends a long causal prompt
around the ring (:mod:`repro_torch.distributed.ring_attention`) under
the reference's conditions.  A mesh without a model axis, or a 1-rank
one, takes the unsharded path exactly.

Gradients: when grad is enabled and an input requires it,
``attention`` and ``ssm_scan`` go through :mod:`.autograd`'s
``FlashAttentionFn`` and ``SelectiveScanFn`` (K1 and K9 forward, the
closed-form backward in PyTorch ops; the plain forward on a CPU tensor),
unless ``use_kernel=False`` asks for the plain version, whose own ops
autograd differentiates.  Every other entry point raises
``RuntimeError`` there (:func:`.autograd.refuse_grad`): its kernel has
no backward.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import at
from ..distributed.collectives import all_gather
from ..distributed.process_mesh import Mesh
from . import flash_attention as fa
from . import paged_attention as pa
from . import ref
from .autograd import (FlashAttentionFn, SelectiveScanFn, refuse_grad,
                       wants_grad)
from .flash_attention import flash_attention, flash_decode
from .matmul import matmul
from .paged_attention import (flash_paged_decode, flash_paged_decode_quant,
                              flash_paged_prefill, flash_paged_prefill_quant)
from .ssm_scan import selective_scan


_TILE_KEYS = ("block_q", "block_k")


def set_tuned(name: str, **pps) -> None:
    """Deprecated, as in the JAX package: use ``repro_torch.at.publish``
    (kept as a thin shim)."""
    at.publish(name, **pps)


def tuned(name: str, **bps) -> dict:
    """What ``at.tuned(name, **bps)`` publishes for the kernel ``name``."""
    return at.tuned(name, **bps)


def _tuned(key: str, names: tuple[str, ...], fits, **explicit) -> dict:
    """What ``at.tuned(key)`` publishes, updated by the explicit keyword
    arguments that are not None, filtered to the ``names`` the kernel
    takes.

    ``at.tuned`` is shape-blind: a tile tuned for one model (yi-6b's
    prefill block_q 4, a 32-row tile at G 8) stays published while the
    process launches another (llama4-scout at G 5, where block_q 4 is a
    20-row tile with no instance).  So a published tile is taken only if
    ``fits(**tile)`` accepts it (the wrapper's tile check, which raises
    ``ValueError`` for a tile with no instance at the launch's shape);
    else the launch runs its default tile.  An explicit tile is always
    handed on, and raises there if it has no instance."""
    kw = at.tuned(key)
    tile = {k: kw.pop(k) for k in _TILE_KEYS if k in kw}
    if tile:
        try:
            fits(**tile)
        except ValueError:
            tile = {}
    kw.update(tile)
    kw.update({k: v for k, v in explicit.items() if v is not None})
    return {k: v for k, v in kw.items() if k in names}


def _attention_fits(q: torch.Tensor):
    """K1's tile check for a published tile (either value may be absent:
    the default's is taken)."""
    return lambda block_q=None, block_k=None: fa.attention_tile(
        "flash_attention", q, block_q, block_k)


def _decode_fits(name: str, q: torch.Tensor):
    """The decode kernels' tile check for a published tile (``block_k``
    alone; a published ``block_q`` is not theirs)."""
    return lambda block_q=None, block_k=None: pa.decode_tile(name, q,
                                                             block_k)


def _prefill_fits(name: str, q: torch.Tensor, hkv: int):
    """The prefill and verify kernels' tile check for a published tile
    (either value may be absent: the default's is taken)."""
    return lambda block_q=None, block_k=None: pa.prefill_tile(
        name, q, hkv, block_q, block_k)


def _use_kernel(x: torch.Tensor, use_kernel: bool | None) -> bool:
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the CUDA "
                         f"kernels do not run on {x.device}")
    return use_kernel


def mm(x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor | None = None,
       *, epilogue: str = "none", use_kernel: bool | None = None,
       **pps) -> torch.Tensor:
    """GEMM entry point: ``epilogue(x @ y + bias)``.  On the card K8 runs
    with the tiles install-time AT published (``at.tuned("matmul")``),
    overridden by any ``block_m``/``block_n``/``block_k`` in ``pps``; on
    the CPU the plain version.  As in the JAX package, no model code
    calls it: the projections stay on ``@``."""
    refuse_grad("ops.mm", x, y, bias)
    if _use_kernel(x, use_kernel):
        kw = at.tuned("matmul")
        kw.update(pps)
        return matmul(x.contiguous(), y.contiguous(), bias,
                      epilogue=epilogue, **kw)
    return ref.matmul_ref(x, y, bias, epilogue)


#: above this many queries the plain route goes flash-style
#: (:func:`.ref.chunked_attention`), and above this many steps the plain
#: Mamba-1 scan goes by chunks (:func:`.ref.selective_scan_chunked`)
CHUNKED_THRESHOLD = 2048


def _any_tile(block_q=None, block_k=None) -> None:
    """The chunked plain route's tile check: every tile fits."""


def mesh_model_axis(mesh) -> int:
    """Size of the tensor-parallel ``"model"`` axis of ``mesh`` (1 == no
    sharding: no mesh, no model axis, or a 1-rank axis; those all run the
    unsharded code path and stay bit-identical to it).  A mesh must be the
    port's :class:`~repro_torch.distributed.Mesh`, whose process groups
    carry the collectives: any other (an abstract mesh of shapes alone,
    as a dry run over a fake process group would use) raises
    ``NotImplementedError`` naming ROADMAP queue 1, item 10b."""
    if mesh is None:
        return 1
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(
            f"a mesh of type {type(mesh).__name__} carries no process "
            "groups: serving takes a repro_torch.distributed.Mesh "
            "(make_serving_mesh); running over an abstract mesh is the "
            "dry run of ROADMAP queue 1, item 10b")
    if "model" not in mesh.axis_names:
        return 1
    return int(mesh.shape["model"])


def takes_ring(q: torch.Tensor, k: torch.Tensor, causal: bool,
               window: int | None, mesh) -> bool:
    """Does :func:`attention` send this call around the ring?  The JAX
    package's conditions: a model axis of more than one rank, causal, no
    window, self-attention, a length the axis divides, and longer than
    ``CHUNKED_THRESHOLD``."""
    m, seq = mesh_model_axis(mesh), q.shape[2]
    return (m > 1 and causal and window is None and seq == k.shape[2]
            and seq % m == 0 and seq > CHUNKED_THRESHOLD)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None, mesh=None,
              use_kernel: bool | None = None, **pps) -> torch.Tensor:
    """Full (prefill) attention.  q (B, H, Sq, D), k/v (B, Hkv, Sk, D):
    Sk = Sq for self-attention, Sk != Sq for cross attention, which is
    neither causal nor windowed (such a call raises ``ValueError`` on both
    routes).  On the card K1 at the ``block_q`` x ``block_k`` tile
    published under ``flash_attention`` (or in ``pps``), at any length.
    A gradient through it goes through ``FlashAttentionFn`` (unless
    ``use_kernel=False``).  The plain route (``use_kernel=False``, or a
    CPU tensor without a gradient) takes :func:`.ref.chunked_attention`
    above ``CHUNKED_THRESHOLD`` queries, at the ``block_q`` x ``block_k``
    published under ``chunked_attention`` (or in ``pps``), and
    ``attention_ref`` at or below it, as the JAX package's does.  On a
    ``mesh`` whose model axis has more than one rank a long causal
    prompt (:func:`takes_ring`) takes the ring instead, its K/V repeated
    to q's heads under GQA (the ring keeps heads whole and shards the
    sequence); shorter, windowed and indivisible ones fall through to the
    paths above, unsharded."""
    fa.check_lengths(q.shape[2], k.shape[2], causal, window)
    if takes_ring(q, k, causal, window, mesh):
        from ..distributed.ring_attention import make_ring_attention
        refuse_grad("ops.attention over the ring", q, k, v)
        if k.shape[1] != q.shape[1]:
            g = q.shape[1] // k.shape[1]
            k = k.repeat_interleave(g, dim=1)
            v = v.repeat_interleave(g, dim=1)
        return make_ring_attention(mesh, causal=True)(q, k, v)
    kernel = _use_kernel(q, use_kernel)
    kw = (_tuned("flash_attention", ("block_q", "block_k", "scale"),
                 _attention_fits(q), **pps) if kernel else {})
    if use_kernel is not False and wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, kw)
    if kernel:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=causal, window=window, **kw)
    if q.shape[2] > CHUNKED_THRESHOLD:
        return ref.chunked_attention(
            q, k, v, causal=causal, window=window,
            **_tuned("chunked_attention", _TILE_KEYS, _any_tile, **pps))
    return ref.attention_ref(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor | None = None, *,
                     use_kernel: bool | None = None, **pps) -> torch.Tensor:
    """One-token decode.  q (B, H, 1, D), caches (B, Hkv, S, D), kv_len (B,).
    On the card K2 at the ``block_k`` published under ``flash_decode``
    (or in ``pps``)."""
    refuse_grad("ops.decode_attention", q, k, v)
    if _use_kernel(q, use_kernel):
        if kv_len is not None:
            kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
        return flash_decode(q.contiguous(), k.contiguous(), v.contiguous(),
                            kv_len, **_tuned("flash_decode",
                                             ("block_k", "scale"),
                                             _decode_fits("flash_decode", q),
                                             **pps))
    return ref.decode_ref(q, k, v, kv_len)


@dataclasses.dataclass(frozen=True)
class PagedPools:
    """One layer's paged KV state: the ``k``/``v`` page pools, each
    (P, Hkv, page_size, D), and for int8 pools their float32 per-row
    scales ``k_scale``/``v_scale`` (P, Hkv, page_size)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _check_pools(pools: PagedPools) -> None:
    if (pools.k_scale is None) != (pools.v_scale is None):
        raise ValueError(
            "PagedPools carries k_scale without v_scale (or vice versa): "
            "int8 pools quantize both sides, fp pools neither")


def _pool_tensors(pools: PagedPools) -> tuple:
    return (pools.k, pools.v, pools.k_scale, pools.v_scale)


def _check_head_sharding(q: torch.Tensor, pools: PagedPools,
                         m: int) -> None:
    """q carries every head, the pools this rank's KV-head slice."""
    h, hkv = q.shape[1], pools.k.shape[1] * m
    if h % m or (h // m) % pools.k.shape[1]:
        raise ValueError(
            f"tensor-parallel paged attention shards the KV-head axis: "
            f"kv_heads={hkv} (q heads {h}) is not divisible by the mesh's "
            f"'model' axis of size {m} — pick a mesh whose model axis "
            f"divides the head counts, or run unsharded")


def _head_sharded(mesh, local, q: torch.Tensor, pools: PagedPools):
    """``local(q_slice, cluster_hkv)`` on this rank's contiguous slice of
    q's heads (the pools are already its KV-head slice), all-gathered over
    the mesh's ``"model"`` group in head order: every rank ends with the
    whole (B, H, C, D) output, exactly as computed."""
    m = mesh_model_axis(mesh)
    if m == 1:
        return local(q, None)
    _check_head_sharding(q, pools, m)
    out = local(q[:, mesh.head_slice(q.shape[1])], pools.k.shape[1] * m)
    return all_gather(out, mesh.group("model"), dim=1)


def _int32(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device=device, dtype=torch.int32).contiguous()


def paged_decode(q: torch.Tensor, pools: PagedPools, page_table: torch.Tensor,
                 kv_len: torch.Tensor, *, mesh=None,
                 num_splits: int | None = None,
                 use_kernel: bool | None = None, **pps) -> torch.Tensor:
    """Decode attention over a paged KV cache.  q (B, H, 1, D),
    ``page_table`` (B, nblk), ``kv_len`` (B,).  On the card: K3 over fp
    pools, K6a over int8 ones, or with ``num_splits`` above 1 their split
    forms (K5a / K6b) and the combine K5c (for a bf16 q one launch: K5c's
    merge in the split kernel's epilogue), at the ``block_k`` and
    ``num_splits`` published under ``flash_paged_decode`` unless given.
    The plain version ignores tiles and ``num_splits``, as the JAX
    package's does on the CPU.  With ``mesh`` the pools are this rank's
    KV-head slice (module docstring)."""
    refuse_grad("ops.paged_decode", q, *_pool_tensors(pools))
    _check_pools(pools)
    kernel = _use_kernel(q, use_kernel)

    def local(q: torch.Tensor, cluster_hkv: int | None) -> torch.Tensor:
        if not kernel:
            return ref.paged_decode_ref(q, pools.k, pools.v, page_table,
                                        kv_len, k_scale=pools.k_scale,
                                        v_scale=pools.v_scale)
        q = q.contiguous()
        table, lens = _int32(page_table, q.device), _int32(kv_len, q.device)
        kw = _tuned("flash_paged_decode", ("block_k", "num_splits", "scale"),
                    _decode_fits("flash_paged_decode", q),
                    num_splits=num_splits, **pps)
        if pools.quantized:
            return flash_paged_decode_quant(
                q, pools.k, pools.v, pools.k_scale, pools.v_scale, table,
                lens, cluster_hkv=cluster_hkv, **kw)
        return flash_paged_decode(q, pools.k, pools.v, table, lens,
                                  cluster_hkv=cluster_hkv, **kw)

    return _head_sharded(mesh, local, q, pools)


def _paged_chunk(q: torch.Tensor, pools: PagedPools,
                 page_table: torch.Tensor, start: torch.Tensor,
                 kv_len: torch.Tensor, mesh, num_splits: int | None,
                 use_kernel: bool | None, tuned_key: str,
                 pps: dict) -> torch.Tensor:
    """The body shared by prefill and verify: on the card K4 over fp
    pools, K6c over int8 ones, or with ``num_splits`` above 1 their split
    forms (K5b / K6d) and the combine K5c (for a bf16 q one launch: K5c's
    merge in the split kernel's epilogue), at the tiles published under
    ``tuned_key`` unless given; the plain version ignores tiles and
    ``num_splits``, as the JAX package's does on the CPU."""
    refuse_grad(f"ops.{tuned_key.removeprefix('flash_')}", q,
                *_pool_tensors(pools))
    _check_pools(pools)
    kernel = _use_kernel(q, use_kernel)

    def local(q: torch.Tensor, cluster_hkv: int | None) -> torch.Tensor:
        if not kernel:
            return ref.paged_prefill_ref(q, pools.k, pools.v, page_table,
                                         start, kv_len,
                                         k_scale=pools.k_scale,
                                         v_scale=pools.v_scale)
        args = (_int32(page_table, q.device), _int32(start, q.device),
                _int32(kv_len, q.device))
        kw = _tuned(tuned_key, ("block_q", "block_k", "num_splits", "scale"),
                    _prefill_fits(tuned_key, q, pools.k.shape[1]),
                    num_splits=num_splits, **pps)
        if pools.quantized:
            return flash_paged_prefill_quant(
                q.contiguous(), pools.k, pools.v, pools.k_scale,
                pools.v_scale, *args, **kw)
        return flash_paged_prefill(q.contiguous(), pools.k, pools.v, *args,
                                   **kw)

    return _head_sharded(mesh, local, q, pools)


def paged_prefill(q: torch.Tensor, pools: PagedPools,
                  page_table: torch.Tensor, start: torch.Tensor,
                  kv_len: torch.Tensor, *, mesh=None,
                  num_splits: int | None = None,
                  use_kernel: bool | None = None, **pps) -> torch.Tensor:
    """Chunked-prefill attention over a paged KV cache.  q (B, H, C, D)
    with its first token at absolute position ``start``; the chunk's K/V
    must already be in the pages (write before read).  On the card at the
    tiles published under ``flash_paged_prefill``."""
    return _paged_chunk(q, pools, page_table, start, kv_len, mesh,
                        num_splits, use_kernel, "flash_paged_prefill", pps)


def paged_verify(q: torch.Tensor, pools: PagedPools,
                 page_table: torch.Tensor, start: torch.Tensor,
                 kv_len: torch.Tensor, *, mesh=None,
                 num_splits: int | None = None,
                 use_kernel: bool | None = None, **pps) -> torch.Tensor:
    """Speculative-verify attention over a paged KV cache: the chunk is
    ``[last committed token, draft_1 .. draft_k]`` (q (B, H, k+1, D) at
    absolute positions from ``start``), the same math through the same
    kernels as :func:`paged_prefill`.  Its own entry point, as in the
    JAX package, whose tuning layer gives verify its own tile space (the
    tiles published under ``flash_paged_verify``); the engine hands
    ``num_splits`` here and to decode, never to prefill."""
    return _paged_chunk(q, pools, page_table, start, kv_len, mesh,
                        num_splits, use_kernel, "flash_paged_verify", pps)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             use_kernel: bool | None = None,
             return_final_state: bool = False, **pps):
    """Mamba-1 selective scan: x, dt (B, L, Di), a (Di, N), b, c (B, L,
    N), d (Di,) -> y (B, L, Di) [, final state (B, Di, N) float32].

    On the card K9 runs, with or without the final state, with the chunk
    install-time AT published (``at.tuned("ssm_scan")``), overridden by a
    ``chunk`` in ``pps``; on the CPU the plain scan, step by step, or in
    chunks (``ref.selective_scan_chunked``) above ``CHUNKED_THRESHOLD``
    steps, where the step loop runs for minutes.  Unlike the JAX
    package's entry, which sends a call that asks for the final state to
    its plain scan, the kernel returns the state itself, so prefill runs
    on it too.  A gradient through y goes through ``SelectiveScanFn``
    (unless ``use_kernel=False``); with the final state it raises, as no
    train forward asks for one."""
    kernel = _use_kernel(x, use_kernel)
    kw = {**at.tuned("ssm_scan"), **pps} if kernel else {}
    if use_kernel is not False and wants_grad(x, dt, a, b, c, d):
        if return_final_state:
            refuse_grad("ops.ssm_scan(return_final_state=True)", x, dt, a,
                        b, c, d)
        return SelectiveScanFn.apply(x, dt, a, b, c, d, kw)
    if kernel:
        return selective_scan(
            x.contiguous(), dt.contiguous(), a.contiguous(),
            b.contiguous(), c.contiguous(), d.contiguous(),
            return_final_state=return_final_state, **kw)
    if x.shape[1] > CHUNKED_THRESHOLD:
        return ref.selective_scan_chunked(x, dt, a, b, c, d,
                                          return_final_state)
    return ref.selective_scan_ref(x, dt, a, b, c, d, return_final_state)
