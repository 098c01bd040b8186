"""FIBER tuning passes wired to the port's kernels: install-time (the
GEMM's tile shapes and the selective scan's chunk).  Before-execute-time
and run-time tuning come later."""
from .install import (matmul_blocks_cost, register_kernel_regions,
                      run_install_tuning, ssm_chunk_cost)
__all__ = ["matmul_blocks_cost", "register_kernel_regions",
           "run_install_tuning", "ssm_chunk_cost"]
