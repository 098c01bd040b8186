"""Run-time AT across the ranks of a tensor-parallel mesh: rank 0 decides.

Every rank of a mesh runs the same serving engine and routes the same
calls through the same regions, so the regions measure the same
candidates at the same calls; only the host clock's costs differ from
rank to rank, and with them the winner each would commit.  Ranks that
commit different variants fall out of step.  So under a mesh of more
than one rank:

* :class:`RankZeroContext` commits rank 0's winner on every rank (its
  ``_commit_dynamic`` broadcasts rank 0's choice; the record and the
  parameter file then hold it);
* :func:`mesh_session` gives rank 0 the workdir and every other rank a
  temporary one of its own, so that only rank 0 writes the records;
* :func:`sync_committed`, once the tuner's regions are declared and
  warm-loaded, puts rank 0's view (committed or still measuring) on
  every rank, so that a workdir only rank 0 reads starts every rank in
  the same state.
"""
from __future__ import annotations

import shutil
import tempfile
import weakref

from .. import at
from ..core.runtime import ATContext
from ..distributed.collectives import broadcast_object


class RankZeroContext(ATContext):
    """An ``ATContext`` whose dynamic commits are rank 0's."""

    def _commit_dynamic(self, region, st) -> int:
        return broadcast_object(super()._commit_dynamic(region, st))


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def mesh_session(workdir: str, mesh, **kw) -> at.AutoTuner:
    """The serve's AT session: as ever without a mesh of more than one
    rank; under one, a :class:`RankZeroContext` in ``workdir`` on rank 0
    and in a temporary directory (removed with the session) elsewhere.
    ``kw`` goes to ``at.AutoTuner``."""
    if not _sharded(mesh):
        return at.AutoTuner(workdir, **kw)
    if mesh.rank != 0:
        workdir = tempfile.mkdtemp(prefix=f"repro_at_rank{mesh.rank}_")
    session = at.AutoTuner(workdir, ctx=RankZeroContext(workdir), **kw)
    if mesh.rank != 0:
        weakref.finalize(session, shutil.rmtree, workdir, True)
    return session


def sync_committed(tuner, mesh) -> None:
    """Rank 0's committed winner (or None: still measuring) of every
    region the tuner declared, on every rank."""
    if not _sharded(mesh):
        return
    states = tuner.ctx.dynamic_state
    theirs = broadcast_object({n: st.committed for n, st in states.items()})
    for name, committed in theirs.items():
        states[name].committed = committed
