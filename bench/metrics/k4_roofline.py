"""K4, the paged prefill kernel (``paged_prefill.cu``): its least time on
the card over its device time in the traced window, in percent.  Per
launch (one a layer a prompt chunk): K and V rows 0..end-1 read once, the
chunk's valid q rows read and o rows written (bf16), 4 x H x Dh
operations a (query, key) pair of the causal chunk."""
from benchcore import readers
from roofline import flops as fl

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels: K4 paged prefill (kernels/ops.py, paged_prefill.cu)"
MOVES = "output_tok_s"
KERNELS = ("paged_prefill_tc_kernel",)


def read(rec: dict) -> float | None:
    m = rec["dims"]
    work = [fl.k4_launch(m, s, e) for s, e, _ in rec.get("trace_chunks", ())
            for _ in range(m["L"])]
    return readers.roofline_share(rec, work, KERNELS)
