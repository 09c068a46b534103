"""surface_multigrid_code_tpu — accelerator-native surface multigrid.

A from-scratch JAX/XLA implementation of the capabilities of
"Surface Multigrid via Intrinsic Prolongation" (Liu, Zhang, Ben-Chen,
Jacobson; SIGGRAPH 2021), designed for a data-parallel accelerator:

- Host precompute (offline): SSP decimation with successive
  self-parameterization, emitting flat arrays (CSR/ELL prolongations,
  flattened collapse logs).
- Device runtime (online): jitted Galerkin multigrid V-cycles with
  multi-color Gauss-Seidel / Jacobi / Chebyshev smoothing on ELL and
  3x3-block (BSR) operators left to XLA, dense coarse solves, and
  shard_map-based multi-device row partitioning.

Reference behavior is documented against HTDerekLiu/surface_multigrid_code
(file:line cites in docstrings); the implementation is new.
"""

from surface_multigrid_code_tpu.utils.hostmem import pool_host_allocations

pool_host_allocations()

from surface_multigrid_code_tpu.config import (
    MGConfig,
    SolveConfig,
    DecimationType,
)
from surface_multigrid_code_tpu.solver.hierarchy import (
    extend_hierarchy,
    get_prolong,
    get_prolong_block,
    load_hierarchy,
    mg_precompute,
    mg_precompute_block,
    save_hierarchy,
)
from surface_multigrid_code_tpu.solver.serialize import (
    load_device_hierarchy,
    save_device_hierarchy,
)
from surface_multigrid_code_tpu.solver.refresh import RefreshableMGSolver
from surface_multigrid_code_tpu.solver.mqwf_mg import (
    min_quad_with_fixed_mg_precompute,
    min_quad_with_fixed_mg_solve,
)
from surface_multigrid_code_tpu.ssp.decimate import SSP_decimate
from surface_multigrid_code_tpu.query.maps import (
    query_fine_to_coarse,
    query_coarse_to_fine,
)

__version__ = "0.1.0"

__all__ = [
    "MGConfig",
    "SolveConfig",
    "DecimationType",
    "get_prolong",
    "get_prolong_block",
    "mg_precompute",
    "mg_precompute_block",
    "min_quad_with_fixed_mg_precompute",
    "min_quad_with_fixed_mg_solve",
    "RefreshableMGSolver",
    "SSP_decimate",
    "query_fine_to_coarse",
    "query_coarse_to_fine",
    "save_hierarchy",
    "load_hierarchy",
    "extend_hierarchy",
    "save_device_hierarchy",
    "load_device_hierarchy",
]
