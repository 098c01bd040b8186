"""The whole serving step's share of the bf16 peak: the model operations
of every prompt token and generated token of the traced window (the
products, the LM head where its logits are used, and causal attention by
position), over the traced window's seconds and the card's peak."""
from benchcore import readers

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "whole serving step (serving/engine.py over models/transformer.py)"
MOVES = "output_tok_s"


def read(rec: dict) -> float | None:
    tr = rec.get("trace")
    if tr is None:
        return None
    return readers.mfu(rec, readers.serve_trace_flops(rec), tr["window_s"])
