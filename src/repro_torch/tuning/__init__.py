"""FIBER tuning passes wired to the port's kernels: install-time (kernel
tile shapes).  Before-execute-time and run-time tuning come later."""
from .install import matmul_blocks_cost, register_kernel_regions, \
    run_install_tuning
__all__ = ["matmul_blocks_cost", "register_kernel_regions",
           "run_install_tuning"]
