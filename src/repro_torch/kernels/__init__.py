"""Attention kernels of the port: CUDA sources in ``csrc``, their ctypes
wrappers (:mod:`.flash_attention`), plain PyTorch versions (:mod:`.ref`)
and the device dispatch the model calls (:mod:`.ops`)."""
