"""Published peaks of the cards the benchmark runs on, keyed by the name
``torch.cuda.get_device_name()`` gives (NVIDIA H100 Tensor Core GPU
datasheet, dense rates without sparsity).  The rates assume the card's
full power limit (700 W for the SXM part); a run writes the card's own
limit beside every share it reports (``nvidia-smi``'s ``power.limit``)."""
from __future__ import annotations

#: name -> (bf16 dense FLOP/s, HBM bytes/s, rated power limit W)
PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12, 700.0),
}


def peaks(device_name: str) -> tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) of the card; KeyError for a card the table
    lacks (a share against a guessed peak is worse than none)."""
    flops, bw, _ = PEAKS[device_name]
    return flops, bw
