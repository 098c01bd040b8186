"""Operations and bytes of the work a run drove, from its shapes and its
traffic, frozen here (never the program's own counters).

``m`` is :func:`benchcore.weights.dims` of a configuration.  A product's
operations are 2 per multiply-add; causal attention over a query at
absolute position ``p`` reads ``p + 1`` keys, and costs 4 x H x Dh per
key (q.k and p.v).  Bytes count each input read once and each output
written once, in the dtype it is stored in (bf16 pools, q and o: 2
bytes), whatever the kernel reads again.
"""
from __future__ import annotations

BF16 = 2


def layer_params(m: dict) -> int:
    """Weights one layer multiplies by (its products; norms excluded)."""
    d, hq, hkv = m["d"], m["H"] * m["Dh"], m["Hkv"] * m["Dh"]
    return d * hq + 2 * d * hkv + hq * d + 3 * d * m["ff"]


def head_params(m: dict) -> int:
    return m["d"] * m["V"]


def keys_upto(start: int, end: int) -> int:
    """Sum of (p + 1) over the query positions p in [start, end)."""
    return (end * (end + 1) - start * (start + 1)) // 2


def attn_flops(m: dict, start: int, end: int) -> int:
    """One layer's causal attention for queries [start, end)."""
    return 4 * m["H"] * m["Dh"] * keys_upto(start, end)


def decode_token_flops(m: dict, pos: int) -> int:
    """A decode step's model operations for one lane whose new token sits
    at position ``pos`` (its logits over the whole vocabulary)."""
    return (2 * (m["L"] * layer_params(m) + head_params(m))
            + m["L"] * attn_flops(m, pos, pos + 1))


def prefill_chunk_flops(m: dict, start: int, end: int,
                        logit_rows: int = 1) -> int:
    """A prompt chunk's model operations over its valid tokens [start,
    end), with ``logit_rows`` rows through the LM head."""
    return (2 * m["L"] * layer_params(m) * (end - start)
            + 2 * head_params(m) * logit_rows
            + m["L"] * attn_flops(m, start, end))


def k3_launch(m: dict, positions) -> tuple[int, int]:
    """(operations, bytes) of one paged-decode launch (one layer) over the
    lanes decoding at ``positions``: each lane's K and V rows 0..pos once,
    its q read and its o written."""
    hkv_row = m["Hkv"] * m["Dh"] * BF16
    qo = m["H"] * m["Dh"] * BF16 * 2
    flops = sum(attn_flops(m, p, p + 1) for p in positions)
    nbytes = sum((p + 1) * hkv_row * 2 + qo for p in positions)
    return flops, nbytes


def k4_launch(m: dict, start: int, end: int) -> tuple[int, int]:
    """(operations, bytes) of one paged-prefill launch (one layer) over a
    chunk of valid queries [start, end): K and V rows 0..end-1 once, the
    chunk's q read and o written."""
    hkv_row = m["Hkv"] * m["Dh"] * BF16
    qo = m["H"] * m["Dh"] * BF16 * 2
    return attn_flops(m, start, end), end * hkv_row * 2 + (end - start) * qo


def train_step_flops(m: dict, batch: int, seq: int) -> int:
    """Model operations of one training step (forward and backward, no
    recomputation): 6 per parameter per token for the products and the LM
    head, and three times the causal attention's forward."""
    tokens = batch * seq
    return (6 * (m["L"] * layer_params(m) + head_params(m)) * tokens
            + 3 * batch * m["L"] * attn_flops(m, 0, seq))
