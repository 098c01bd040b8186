"""PyTorch/CUDA port of the serving stack of :mod:`repro`.

The layout mirrors the JAX package module for module.  The port imports
``torch`` and ``numpy`` only: nothing of JAX and nothing of the JAX
package, whose jax-free modules it keeps its own copies of.  Attention
runs through hand-written CUDA kernels for Hopper (``kernels/csrc``) on
a CUDA tensor and through their plain PyTorch versions on a CPU tensor.
"""
