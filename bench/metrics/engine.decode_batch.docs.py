"""Tokens a decode tick emitted: the window's tokens less its first
tokens (which prompt chunks emit), over the engine's decode ticks
(``ServingEngine.steps``) in the window."""
UNIT, BETTER, SOURCE = "lanes", "higher", "program_counter"
LAYER = "engine (serving/engine.py)"
MOVES = "output_tok_s"


def read(rec: dict) -> float | None:
    a, b = rec["marks"]["t0"], rec["marks"]["t1"]
    steps = b["steps"] - a["steps"]
    if steps <= 0:
        return None
    first = sum(1 for _, r in rec["reqs"] if r.first_token_t is not None
                and a["t"] <= r.first_token_t <= b["t"])
    return (b["tokens"] - a["tokens"] - first) / steps
