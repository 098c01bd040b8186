"""``repro_torch.at`` — the public auto-tuning API (one frontend, paper-faithful).

The paper's single ``!OAT$`` directive surface, reproduced as one session
object instead of four parallel frontends:

* :class:`AutoTuner` — the session: declare regions with the
  :meth:`~repro_torch.at.session.AutoTuner.autotune` decorator (or the comment
  DSL via :meth:`~repro_torch.at.session.AutoTuner.preprocess`), run phases with
  :meth:`~repro_torch.at.session.AutoTuner.run`, invoke regions with
  :meth:`~repro_torch.at.session.AutoTuner.execute`.
* :func:`tuned` — what kernels call to pick up tuned PPs (replaces the
  ``ops.set_tuned`` side-channel).
* :data:`searchers` / :data:`executors` / :data:`record_backends` —
  pluggable backend registries; new strategies and storage layers
  register by name instead of editing the runtime.
* :class:`ATRecordStore` — the persistent tuning database (JSON-lines
  under the workdir, keyed by machine fingerprint + region + BP point);
  install/static optima survive process restarts and are warm-loaded
  without re-timing.  :class:`SqliteRecordStore` is the transactional
  fleet-grade alternative, and :func:`open_record_store` overlays either
  on a read-only **golden** winner DB (a record file of winners from
  another deployment).

Phase constants (``INSTALL``/``STATIC``/``DYNAMIC``/``ALL``) and the
declaration vocabulary (:class:`Varied`, :class:`Fitting`,
:class:`According`, :class:`ParamDecl`) are re-exported so application
code needs no ``repro_torch.core`` imports.
"""
from ..core.cost import According
from ..core.params import ParamDecl, Varied
from ..core.region import ATRegion, Fitting
from ..core.runtime import (OAT_ALL, OAT_DYNAMIC, OAT_INSTALL, OAT_STATIC)
from .backends import BackendRegistry, executors, searchers
from .records import (ATRecordStore, ATRecordWarning, GoldenOverlayStore,
                      GoldenStore, RecordBackend, TuningRecord,
                      machine_fingerprint, open_record_store,
                      read_records_file, record_backends,
                      reset_fingerprint_cache, write_records_file)
from .sqlite_backend import SqliteRecordStore
from .session import (AutoTuner, SelectHandle, TunedRegion, clear_published,
                      current_session, publish, publish_for_bp, tuned,
                      use_session)

# friendlier aliases for the paper's §6.1 constants
ALL = OAT_ALL
INSTALL = OAT_INSTALL
STATIC = OAT_STATIC
DYNAMIC = OAT_DYNAMIC


def autotune(*args, **kwargs):
    """Module-level :meth:`AutoTuner.autotune` against the current session
    (creating a default session in the cwd if none is active)."""
    session = current_session() or AutoTuner()
    return session.autotune(*args, **kwargs)


__all__ = [
    "ALL", "INSTALL", "STATIC", "DYNAMIC",
    "OAT_ALL", "OAT_INSTALL", "OAT_STATIC", "OAT_DYNAMIC",
    "ATRecordStore", "ATRecordWarning", "ATRegion", "According",
    "AutoTuner", "BackendRegistry", "Fitting", "GoldenOverlayStore",
    "GoldenStore", "ParamDecl", "RecordBackend", "SelectHandle",
    "SqliteRecordStore", "TunedRegion", "TuningRecord", "Varied",
    "autotune", "clear_published", "current_session", "executors",
    "machine_fingerprint", "open_record_store", "publish",
    "publish_for_bp", "read_records_file", "record_backends",
    "reset_fingerprint_cache", "searchers", "tuned", "use_session",
    "write_records_file",
]
