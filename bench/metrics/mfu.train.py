"""The whole train step's share of the bf16 peak: 6 operations a
parameter a token for the products and the LM head, plus three times the
causal attention's forward, for every token of the window's whole steps,
over the window's seconds and the card's peak."""
from benchcore import readers
from roofline import flops as fl

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "whole train step (launch/steps.py build_train_step, serving/compiled.py)"
MOVES = "train_tok_s"


def read(rec: dict) -> float | None:
    f = fl.train_step_flops(rec["dims"], rec["batch"], rec["seq_len"])
    return readers.mfu(rec, f * rec["steps"], rec["window_s"])
