"""Attention kernels of the port: CUDA sources in ``csrc``, their ctypes
wrappers (:mod:`.flash_attention` for the dense K1/K2,
:mod:`.paged_attention` for the paged K3-K6: decode, prefill chunk,
split-KV decode and its combine, int8 pages), plain PyTorch versions
(:mod:`.ref`) and the device dispatch the model calls (:mod:`.ops`)."""
