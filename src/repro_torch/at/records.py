"""Persistent tuning database — pluggable record backends.

The paper pays tuning cost at install/static time and amortises it over
every later run; this module makes that durable across *processes* and
*machines*: every tuned optimum is persisted under the session workdir,
keyed by

    (machine fingerprint, phase, region name, canonical BP point)

so a fresh :class:`~repro_torch.at.session.AutoTuner` pointed at the same workdir
reloads install/static optima without re-timing anything (the warm path).

Storage is pluggable behind the :data:`record_backends` registry (the same
shape as ``at.searchers`` / ``at.executors``):

=======  ==============================================================
backend  semantics
=======  ==============================================================
jsonl    :class:`ATRecordStore` — append-only JSON lines, one atomic
         ``O_APPEND`` write per record (concurrent serve/bench workers
         cannot interleave partial lines); the default
sqlite   :class:`~repro_torch.at.sqlite_backend.SqliteRecordStore` — a single
         transactional file, safe under concurrent writers
memory   :class:`RecordBackend` itself — ephemeral, for tests
=======  ==============================================================

On top of any backend sits the **golden** overlay
(:class:`GoldenOverlayStore`): a read-only, fingerprint-keyed winner DB
(a record file of winners exported from a tuned fleet; this package
has no export CLI yet) consulted whenever the local store misses — local record
beats golden, golden beats cold.  A fresh deployment pointed at a golden
DB warm-loads fleet-tuned
optima with zero measurements.

The paper's human-readable ``OAT_*Param.dat`` S-expression files are still
written by the runtime for fidelity; this store is the machine-queryable
index over the same results.
"""
from __future__ import annotations

import json
import math
import os
import warnings
from dataclasses import asdict, dataclass, field
from typing import Any, Iterable, Iterator

from .backends import BackendRegistry

RECORDS_FILENAME = "OAT_Records.jsonl"

_fingerprint_cache: str | None = None


class ATRecordWarning(RuntimeWarning):
    """A tuning-DB integrity problem that degraded gracefully (corrupt
    record line, missing golden DB) — never silent, never fatal."""


def machine_fingerprint() -> str:
    """A stable id for 'this machine' as the tuner sees it.

    Install-time PPs depend only on the hardware (paper §3.1), so records
    are scoped by platform + the torch build's CUDA version (or ``cpu``)
    + device name + compute capability + device count: a record tuned on
    one fingerprint is never served to another.  The ``torch`` part keeps
    this package's records apart from those of the JAX package on the
    same machine (same record format, different keys).

    Only the *success* path is cached: a transient failure (torch import
    error, a CUDA query that raises) yields a degraded ``...-notorch``
    fingerprint for that call alone, instead of poisoning every
    subsequent record's key for the life of the process.
    """
    global _fingerprint_cache
    if _fingerprint_cache is not None:
        return _fingerprint_cache
    import platform

    parts = [platform.system().lower(), platform.machine(), "torch"]
    try:
        import torch

        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(0)
            parts += [f"cuda{torch.version.cuda}",
                      torch.cuda.get_device_name(0).replace(" ", "-").lower(),
                      f"sm{major}{minor}",
                      f"n{torch.cuda.device_count()}"]
        else:
            parts += ["cpu", "n1"]
    except Exception:
        # transient failure path: report, don't cache
        return "-".join(p for p in parts if p) + "-notorch"
    _fingerprint_cache = "-".join(p for p in parts if p)
    return _fingerprint_cache


def reset_fingerprint_cache() -> None:
    """Forget the cached fingerprint (tests)."""
    global _fingerprint_cache
    _fingerprint_cache = None


def _jsonable(v: Any) -> Any:
    """Coerce numpy scalars etc. to plain, spec-valid JSON types.

    Non-finite floats become ``None``: ``json.dumps`` would otherwise
    emit ``NaN``/``Infinity`` tokens that strict parsers (sqlite, HTTP
    golden consumers) reject.
    """
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if hasattr(v, "item"):           # numpy scalar
        return _jsonable(v.item())
    return str(v)


def _sanitize_loaded(d: dict) -> dict:
    """Tolerate non-finite floats in records written before sanitization
    (python's json emits/accepts bare ``NaN`` tokens)."""
    c = d.get("cost")
    if isinstance(c, float) and not math.isfinite(c):
        d["cost"] = None
    for part in ("bp", "pp"):
        m = d.get(part)
        if isinstance(m, dict) and any(
                isinstance(v, float) and not math.isfinite(v)
                for v in m.values()):
            d[part] = {k: _jsonable(v) for k, v in m.items()}
    return d


def bp_key(bp: dict[str, Any] | None) -> tuple:
    """Canonical, hashable form of a BP point."""
    if not bp:
        return ()
    return tuple(sorted((str(k), _jsonable(v)) for k, v in bp.items()))


@dataclass
class TuningRecord:
    """One tuned optimum: the PP assignment for a (machine, region, BP)."""

    machine: str
    phase: str                        # install | static | dynamic
    region: str
    bp: dict[str, Any] = field(default_factory=dict)
    pp: dict[str, Any] = field(default_factory=dict)
    cost: float | None = None
    n_evaluations: int | None = None

    @property
    def key(self) -> tuple:
        return (self.machine, self.phase, self.region, bp_key(self.bp))


def prefer_incoming(cur: TuningRecord, inc: TuningRecord,
                    prefer: str = "better-cost") -> bool:
    """Merge policy for a key collision: does ``inc`` replace ``cur``?"""
    if prefer == "incoming":
        return True
    if prefer == "existing":
        return False
    if prefer != "better-cost":
        raise ValueError(f"unknown merge policy {prefer!r}")
    if inc.cost is None:
        return False
    return cur.cost is None or inc.cost < cur.cost


# --------------------------------------------------------------------------
# the backend interface (+ the in-memory reference backend)
# --------------------------------------------------------------------------

record_backends = BackendRegistry("record")


@record_backends.register("memory")
class RecordBackend:
    """Base class for tuning-DB backends — also the ``memory`` backend.

    Subclasses implement durability: :meth:`_load` repopulates the
    in-memory indexes from storage (via :meth:`_remember`) and
    :meth:`_append` persists one record.  Shared here: the primary
    ``key -> record`` index, a ``(machine, phase, region)`` secondary
    index keeping :meth:`lookup_all` / :meth:`regions` O(1) in the
    record count (the warm path hits them once per region), and the
    fleet operations (:meth:`export` / :meth:`merge_records`).
    ``machine`` defaults to the live fingerprint; tests may pin it to
    simulate foreign machines.
    """

    backend_name = "memory"

    def __init__(self, workdir: str = ".", machine: str | None = None):
        self.workdir = workdir
        self.machine = machine or machine_fingerprint()
        self._index: dict[tuple, TuningRecord] = {}
        # (machine, phase, region) -> {key: record}; replacement by key
        # stays automatic, deletion never happens (append-only store)
        self._by_region: dict[tuple, dict[tuple, TuningRecord]] = {}
        self._load()

    # -- storage hooks --------------------------------------------------
    def _load(self) -> None:
        pass

    def _append(self, rec: TuningRecord) -> None:
        pass

    # -- indexing -------------------------------------------------------
    def _remember(self, rec: TuningRecord) -> None:
        self._index[rec.key] = rec
        self._by_region.setdefault(
            (rec.machine, rec.phase, rec.region), {})[rec.key] = rec

    # -- the store API --------------------------------------------------
    def put(self, phase: str, region: str, bp: dict[str, Any] | None,
            pp: dict[str, Any], cost: float | None = None,
            n_evaluations: int | None = None) -> TuningRecord:
        rec = TuningRecord(
            machine=self.machine, phase=phase, region=region,
            bp={str(k): _jsonable(v) for k, v in (bp or {}).items()},
            pp={str(k): _jsonable(v) for k, v in pp.items()},
            cost=None if cost is None else _jsonable(float(cost)),
            n_evaluations=n_evaluations)
        return self.put_record(rec)

    def put_record(self, rec: TuningRecord) -> TuningRecord:
        """Store a fully-formed record, preserving its machine key (the
        merge path: fleet records keep the fingerprint that tuned them)."""
        self._remember(rec)
        self._append(rec)
        return rec

    def lookup(self, phase: str, region: str,
               bp: dict[str, Any] | None = None) -> TuningRecord | None:
        return self._index.get((self.machine, phase, region, bp_key(bp)))

    def lookup_all(self, phase: str, region: str) -> list[TuningRecord]:
        return list(self._by_region.get(
            (self.machine, phase, region), {}).values())

    def records(self) -> Iterator[TuningRecord]:
        return iter(self._index.values())

    def regions(self, phase: str) -> list[str]:
        return sorted({r for m, p, r in self._by_region
                       if m == self.machine and p == phase})

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, key: tuple) -> bool:
        return key in self._index

    def describe(self) -> dict:
        """One-line identity for reports (`/v1/stats`, the serve report)."""
        return {"backend": self.backend_name,
                "path": getattr(self, "path", None),
                "machine": self.machine, "records": len(self),
                "golden": None}

    # -- fleet operations ----------------------------------------------
    def export(self, path: str, machine: str | None = None,
               phase: str | None = None) -> int:
        """Write records (all machines by default) to a golden file;
        format by extension (``.sqlite``/``.db`` → sqlite, else JSONL)."""
        recs = [r for r in self.records()
                if machine in (None, "all") or r.machine == machine]
        if phase is not None:
            recs = [r for r in recs if r.phase == phase]
        write_records_file(path, recs)
        return len(recs)

    def merge_records(self, records: Iterable[TuningRecord],
                      prefer: str = "better-cost") -> dict[str, int]:
        """Import fleet records; collisions resolve per ``prefer``
        (``better-cost`` default: lower measured cost wins)."""
        added = updated = kept = 0
        for rec in records:
            cur = self._index.get(rec.key)
            if cur is None:
                self.put_record(rec)
                added += 1
            elif prefer_incoming(cur, rec, prefer):
                self.put_record(rec)
                updated += 1
            else:
                kept += 1
        return {"added": added, "updated": updated, "kept": kept}


# --------------------------------------------------------------------------
# JSONL backend — the default
# --------------------------------------------------------------------------

@record_backends.register("jsonl")
class ATRecordStore(RecordBackend):
    """JSON-lines tuning database under ``workdir``.

    Append-only on disk (one JSON object per line; last record for a key
    wins on load), fully indexed in memory.  Each ``put`` is a single
    ``os.O_APPEND`` write, so concurrent serve/bench processes appending
    to the same file cannot interleave partial lines; a corrupt line
    (torn write from a pre-fix process, disk truncation) is skipped with
    an :class:`ATRecordWarning` naming the line, never silently.
    """

    backend_name = "jsonl"

    def __init__(self, workdir: str = ".", machine: str | None = None,
                 path: str | None = None):
        self.path = path or os.path.join(workdir, RECORDS_FILENAME)
        super().__init__(workdir, machine=machine)

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path, "r") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = TuningRecord(**_sanitize_loaded(json.loads(line)))
                except (json.JSONDecodeError, TypeError):
                    warnings.warn(
                        f"{self.path}:{lineno}: skipping corrupt tuning "
                        f"record (torn write?) — any winner on this line "
                        f"will re-tune", ATRecordWarning, stacklevel=2)
                    continue
                self._remember(rec)

    def _append(self, rec: TuningRecord) -> None:
        parent = os.path.dirname(self.path)
        os.makedirs(parent or ".", exist_ok=True)
        data = (json.dumps(asdict(rec), allow_nan=False) + "\n").encode()
        # one write() of one whole line: O_APPEND makes it atomic w.r.t.
        # other appenders, so records never interleave mid-line
        fd = os.open(self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                     0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)


# --------------------------------------------------------------------------
# golden winners — read-only store + read-through overlay
# --------------------------------------------------------------------------

_SQLITE_MAGIC = b"SQLite format 3"


def read_records_file(path: str) -> list[TuningRecord]:
    """Load records from a golden DB file, sniffing sqlite vs JSONL."""
    with open(path, "rb") as f:
        magic = f.read(len(_SQLITE_MAGIC))
    if magic == _SQLITE_MAGIC:
        from .sqlite_backend import SqliteRecordStore
        return list(SqliteRecordStore(path=path).records())
    return list(ATRecordStore(os.path.dirname(path) or ".",
                              path=path).records())


def write_records_file(path: str, records: Iterable[TuningRecord]) -> None:
    """Write a golden DB file (fresh), format chosen by extension."""
    parent = os.path.dirname(path)
    os.makedirs(parent or ".", exist_ok=True)
    if path.endswith((".sqlite", ".db")):
        from .sqlite_backend import SqliteRecordStore
        if os.path.exists(path):
            os.remove(path)
        store = SqliteRecordStore(path=path)
        for rec in records:
            store.put_record(rec)
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for rec in records:
            f.write(json.dumps(asdict(rec), allow_nan=False) + "\n")
    os.replace(tmp, path)


class GoldenStore(RecordBackend):
    """Read-only view of an exported golden DB file (any format)."""

    backend_name = "golden"

    def __init__(self, path: str, machine: str | None = None):
        self.path = path
        super().__init__(os.path.dirname(path) or ".", machine=machine)

    def _load(self) -> None:
        if not os.path.exists(self.path):
            warnings.warn(f"golden DB {self.path} not found; the overlay "
                          f"is empty", ATRecordWarning, stacklevel=2)
            return
        for rec in read_records_file(self.path):
            self._remember(rec)

    def _append(self, rec: TuningRecord) -> None:
        raise RuntimeError(f"golden DB {self.path} is read-only; "
                           f"merge it into a local store instead")


class GoldenOverlayStore:
    """Read-through overlay: a writable local store over a read-only
    golden DB.  Precedence is *local record beats golden, golden beats
    cold*: lookups try the local store first, writes go only to it —
    re-tuned optima shadow the fleet's without mutating the shipped DB.
    """

    def __init__(self, primary: RecordBackend, golden: RecordBackend):
        self.primary = primary
        self.golden = golden

    @property
    def backend_name(self) -> str:
        return f"{self.primary.backend_name}+golden"

    @property
    def workdir(self) -> str:
        return self.primary.workdir

    @property
    def machine(self) -> str:
        return self.primary.machine

    @property
    def path(self):
        return getattr(self.primary, "path", None)

    # writes → local only
    def put(self, *args, **kwargs) -> TuningRecord:
        return self.primary.put(*args, **kwargs)

    def put_record(self, rec: TuningRecord) -> TuningRecord:
        return self.primary.put_record(rec)

    def merge_records(self, records, prefer: str = "better-cost"):
        return self.primary.merge_records(records, prefer=prefer)

    # reads → local first, golden fallback
    def lookup(self, phase: str, region: str,
               bp: dict[str, Any] | None = None) -> TuningRecord | None:
        return self.primary.lookup(phase, region, bp) \
            or self.golden.lookup(phase, region, bp)

    def lookup_all(self, phase: str, region: str) -> list[TuningRecord]:
        merged = {r.key: r for r in self.golden.lookup_all(phase, region)}
        merged.update(
            {r.key: r for r in self.primary.lookup_all(phase, region)})
        return list(merged.values())

    def records(self) -> Iterator[TuningRecord]:
        merged = {r.key: r for r in self.golden.records()}
        merged.update({r.key: r for r in self.primary.records()})
        return iter(merged.values())

    def regions(self, phase: str) -> list[str]:
        return sorted(set(self.primary.regions(phase))
                      | set(self.golden.regions(phase)))

    def __len__(self) -> int:
        return sum(1 for _ in self.records())

    def __contains__(self, key: tuple) -> bool:
        return key in self.primary or key in self.golden

    def export(self, path: str, machine: str | None = None,
               phase: str | None = None) -> int:
        recs = [r for r in self.records()
                if machine in (None, "all") or r.machine == machine]
        if phase is not None:
            recs = [r for r in recs if r.phase == phase]
        write_records_file(path, recs)
        return len(recs)

    def describe(self) -> dict:
        out = self.primary.describe()
        out["backend"] = self.backend_name
        out["records"] = len(self)
        out["golden"] = self.golden.path
        return out


def open_record_store(workdir: str = ".", *, backend: str = "jsonl",
                      machine: str | None = None,
                      golden_db: str | None = None):
    """Open the tuning DB for a workdir: a registered backend, optionally
    overlaid on a read-only golden DB (``golden_db`` path)."""
    store = record_backends.get(backend)(workdir, machine=machine)
    if golden_db:
        store = GoldenOverlayStore(
            store, GoldenStore(golden_db, machine=store.machine))
    return store
