"""ppOpen-AT core — the paper's contribution, ported to PyTorch.

Module map (application code should import ``repro_torch.at`` instead — this
package is the engine underneath it):

===============  ==========================================================
module           role
===============  ==========================================================
``region``       AT region model (§3.4): types/features, nesting legality
                 (Tables 1-2), the ``RegionRegistry``
``params``       BP/PP parameter store + FIBER visibility hierarchy
                 (Fig. 4), ``Varied`` ranges, reserved words (§6.1)
``runtime``      ``ATContext`` — ``OAT_ATexec`` and the §4 API: phase
                 priority, BP sweeps, run-time candidate selection;
                 pluggable ``searcher`` / ``executor_factory`` hooks the
                 ``repro_torch.at`` backend registries plug into
``search``       §6.4.2 search composition (Sample 10 counts exactly)
``fitting``      §3.4.3 fitting: least-squares / d-Spline / user-defined
``cost``         ``according`` clauses: min/condition/estimated + roofline
``executor``     measurement backends: wall-clock / cost-model / table
``paramfile``    the S-expression parameter files (§4.2.1, §6.2)
``dsl``          ``#OAT$`` comment-directive parsing (the paper surface)
``codegen``      §5 loop transforms: split/fusion/collapse/unroll variants
``directives``   DEPRECATED decorator frontend — thin shims over
                 ``region()`` kept for compatibility; use
                 ``repro_torch.at.AutoTuner.autotune`` (docs/API.md)
``stagegraph``   stage-graph execution planning over tuned regions
``errors``       the ``OAT*Error`` hierarchy
===============  ==========================================================

Layered on top (not imported here): ``repro_torch.at`` — the public session API
(AutoTuner, backend registries, the persistent ``ATRecordStore``).
"""
from .cost import According, RooflineTerms, roofline_seconds, roofline_terms
from .directives import (SelectRegion, dynamic_select, dynamic_unroll,
                         dynamic_variable, install_define, install_select,
                         install_unroll, install_variable, region,
                         static_select, static_unroll, static_variable)
from .errors import (OATCodegenError, OATError, OATHierarchyError,
                     OATMissingBasicParamError, OATNestingError,
                     OATParamCollisionError, OATPriorityError, OATSpecError)
from .executor import (CostModelExecutor, CountingExecutor, TableExecutor,
                       WallClockExecutor)
from .params import (DEFAULT_BASIC_PARAMS, OAT_DEBUG, OAT_ENDTUNESIZE,
                     OAT_NUMPROCS, OAT_SAMPDIST, OAT_STARTTUNESIZE,
                     OAT_TUNEDYNAMIC, OAT_TUNESTATIC, ParamDecl, ParamStore,
                     Varied)
from .region import ATRegion, Fitting, RegionRegistry, Subregion
from .runtime import (OAT_ALL, OAT_DYNAMIC, OAT_INSTALL, OAT_STATIC,
                      ATContext, default_context, reset_default_context)
from .search import SearchPlan, predicted_count, search_region

__all__ = [
    "ATContext", "ATRegion", "According", "CostModelExecutor",
    "CountingExecutor", "Fitting", "OATError", "ParamStore", "RegionRegistry",
    "SearchPlan", "SelectRegion", "TableExecutor", "Varied",
    "WallClockExecutor", "OAT_ALL", "OAT_INSTALL", "OAT_STATIC",
    "OAT_DYNAMIC", "default_context", "predicted_count",
    "reset_default_context", "roofline_terms", "search_region",
]
