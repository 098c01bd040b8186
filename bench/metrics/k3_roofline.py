"""K3, the paged decode kernel (``paged_decode.cu``): its least time on
the card over its device time in the traced window, in percent.  Per
launch (one a layer a decode tick): each decoding lane's K and V rows
0..pos read once, its q read and o written (bf16), 4 x H x Dh operations
a key; the least time is the larger of operations over the bf16 peak and
bytes over the bandwidth."""
from benchcore import readers
from roofline import flops as fl

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels: K3 paged decode (kernels/ops.py, paged_decode.cu)"
MOVES = "output_tok_s"
KERNELS = ("paged_decode_tc_kernel",)


def read(rec: dict) -> float | None:
    m = rec["dims"]
    work = [fl.k3_launch(m, tick) for tick in rec.get("trace_decodes", ())
            for _ in range(m["L"])]
    return readers.roofline_share(rec, work, KERNELS)
