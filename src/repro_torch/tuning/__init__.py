"""FIBER tuning passes wired to the port's kernels and layouts:
install-time (the GEMM's tile shapes, the prefill attention's tile and
the selective scan's chunk), before-execute-time (the layout plan of an
(arch, shape) cell, :mod:`.static`) and run-time (the serving regions of
:mod:`.dynamic`: decode and prefill tiles, the speculative window, the
KV precision, the prefix and gateway policies)."""
from .dynamic import (LEGACY_REGION_ALIASES, DecodeAutoTuner,
                      describe_region, divisor_block_ks, page_block_ks,
                      parse_region, region_key, resolve_region)
from .install import (flash_blocks_cost, matmul_blocks_cost,
                      register_kernel_regions, run_install_tuning,
                      ssm_chunk_cost)
from .static import (analytic_plan_cost, candidate_plans, tune_all_layouts,
                     tune_layout)
__all__ = ["DecodeAutoTuner", "LEGACY_REGION_ALIASES", "analytic_plan_cost",
           "candidate_plans", "describe_region",
           "divisor_block_ks", "flash_blocks_cost", "matmul_blocks_cost",
           "page_block_ks", "parse_region", "region_key",
           "register_kernel_regions",
           "resolve_region", "run_install_tuning", "ssm_chunk_cost",
           "tune_all_layouts", "tune_layout"]
