"""Kernels of the port: CUDA sources in ``csrc``, their ctypes wrappers
(:mod:`.flash_attention` for the dense K1/K2, :mod:`.paged_attention`
for the paged K3-K6: decode, prefill chunk, split-KV decode and its
combine, int8 pages; :mod:`.fdm_stress` for the Sample 8 stress update
K7; :mod:`.matmul` for the GEMM K8; :mod:`.ssm_scan` for the Mamba-1
selective scan K9), plain PyTorch versions
(:mod:`.ref`) and the device dispatch (:mod:`.ops`)."""
