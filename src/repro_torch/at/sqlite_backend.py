"""sqlite tuning-DB backend — one transactional file, concurrency-safe.

The JSONL default is append-only and fine for one writer per line; this
backend is for the fleet shape (ROADMAP item 3): many serve/bench workers
sharing one tuning DB, where every ``put`` must be a transaction and a
key must hold exactly one row (no replay-the-log semantics).  A golden DB
exported with a ``.sqlite`` extension uses the same schema, so a shipped
winner file is directly openable by this backend.

Stdlib ``sqlite3`` only; a connection is opened per operation so forked
workers never share one handle, and the 30 s busy timeout rides out
concurrent writers' transactions.
"""
from __future__ import annotations

import json
import os
import sqlite3

from .records import (RecordBackend, TuningRecord, _sanitize_loaded, bp_key,
                      record_backends)

SQLITE_FILENAME = "OAT_Records.sqlite"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS records (
    machine       TEXT NOT NULL,
    phase         TEXT NOT NULL,
    region        TEXT NOT NULL,
    bp_key        TEXT NOT NULL,
    bp            TEXT NOT NULL,
    pp            TEXT NOT NULL,
    cost          REAL,
    n_evaluations INTEGER,
    PRIMARY KEY (machine, phase, region, bp_key)
)
"""


@record_backends.register("sqlite")
class SqliteRecordStore(RecordBackend):
    """Transactional single-file tuning DB (``OAT_Records.sqlite``).

    Same store API and in-memory indexes as the JSONL backend; on disk a
    key is upserted in place (``INSERT OR REPLACE`` inside a
    transaction), so concurrent workers see whole records or nothing —
    there is no torn-line failure mode to recover from.
    """

    backend_name = "sqlite"

    def __init__(self, workdir: str = ".", machine: str | None = None,
                 path: str | None = None):
        self.path = path or os.path.join(workdir, SQLITE_FILENAME)
        super().__init__(workdir, machine=machine)

    def _connect(self) -> sqlite3.Connection:
        parent = os.path.dirname(self.path)
        os.makedirs(parent or ".", exist_ok=True)
        con = sqlite3.connect(self.path, timeout=30.0)
        con.execute(_SCHEMA)
        return con

    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        con = self._connect()
        try:
            rows = con.execute(
                "SELECT machine, phase, region, bp, pp, cost, "
                "n_evaluations FROM records").fetchall()
        finally:
            con.close()
        for machine, phase, region, bp, pp, cost, n_evals in rows:
            self._remember(TuningRecord(**_sanitize_loaded({
                "machine": machine, "phase": phase, "region": region,
                "bp": json.loads(bp), "pp": json.loads(pp),
                "cost": cost, "n_evaluations": n_evals})))

    def _append(self, rec: TuningRecord) -> None:
        con = self._connect()
        try:
            with con:
                con.execute(
                    "INSERT OR REPLACE INTO records VALUES "
                    "(?, ?, ?, ?, ?, ?, ?, ?)",
                    (rec.machine, rec.phase, rec.region,
                     json.dumps(bp_key(rec.bp)), json.dumps(rec.bp),
                     json.dumps(rec.pp), rec.cost, rec.n_evaluations))
        finally:
            con.close()
