"""``python -m repro_torch.at`` — the tuning-fleet CLI.

Operate on tuning DBs from the shell: inspect what a workdir has tuned,
find what a machine still has to tune, and move fingerprint-keyed winners
between deployments (the MITuna shape: tune anywhere, promote winners to
a golden DB, warm-load everywhere).

=======  ==============================================================
command  semantics
=======  ==============================================================
list     enumerate records grouped per phase and mesh suffix (region
         names parsed through ``tuning.dynamic``; foreign machines
         included with ``--machine all``)
stale    (phase, region) pairs some machine has tuned but the target
         fingerprint has not — the tuning jobs to dispatch
export   dump records to a golden DB file (format by extension:
         ``.sqlite``/``.db`` → sqlite, else JSONL)
merge    import a golden DB into a workdir's store (``--backend`` picks
         jsonl/sqlite; collisions resolve per ``--prefer``)
promote  merge a workdir's winners *into* an existing golden DB,
         keeping the better-cost record per key
=======  ==============================================================

Examples::

    python -m repro_torch.at list --workdir /srv/at --machine all
    python -m repro_torch.at export --workdir /srv/at --out golden.jsonl
    python -m repro_torch.at merge --workdir /tmp/fresh --db golden.jsonl \\
        --backend sqlite
    python -m repro_torch.at promote --workdir /srv/at --db /fleet/golden.sqlite
    python -m repro_torch.at stale --workdir /srv/at --fail-on-stale
"""
from __future__ import annotations

import argparse
import os
from typing import Iterable

from .records import (machine_fingerprint, open_record_store, prefer_incoming,
                      read_records_file, write_records_file)


def _describe(name: str) -> dict | None:
    # lazy: tuning.dynamic pulls the serving stack (torch) in; the pure
    # record operations (export/merge) must not pay for that
    try:
        from ..tuning.dynamic import describe_region
    except Exception:
        return None
    return describe_region(name)


def _open_store(args: argparse.Namespace):
    machine = getattr(args, "machine", None)
    return open_record_store(args.workdir, backend=args.backend,
                             machine=None if machine == "all" else machine)


def _records_of(args: argparse.Namespace) -> Iterable:
    if getattr(args, "db", None) and not os.path.isdir(args.db):
        return read_records_file(args.db)
    return _open_store(args).records()


# --------------------------------------------------------------------------
# commands
# --------------------------------------------------------------------------

def cmd_list(args: argparse.Namespace) -> int:
    recs = list(_records_of(args))
    machine = args.machine or machine_fingerprint()
    if machine != "all":
        recs = [r for r in recs if r.machine == machine]
    if args.phase:
        recs = [r for r in recs if r.phase == args.phase]
    if not recs:
        print("no records")
        return 0

    def group(rec) -> tuple:
        d = _describe(rec.region)
        return (rec.machine, rec.phase, d["mesh"] if d else "")

    by_group: dict[tuple, list] = {}
    for r in recs:
        by_group.setdefault(group(r), []).append(r)
    for (m, phase, mesh), rows in sorted(by_group.items()):
        suffix = f" · mesh {mesh}" if mesh else ""
        print(f"[{m} · {phase}{suffix}] {len(rows)} record(s)")
        for r in sorted(rows, key=lambda r: (r.region, str(r.bp))):
            d = _describe(r.region)
            kind = f" kind={d['kind']}" if d else ""
            bp = f" bp={r.bp}" if r.bp else ""
            cost = f" cost={r.cost:.6g}" if r.cost is not None else ""
            print(f"  {r.region}{kind}{bp} pp={r.pp}{cost}")
    print(f"{len(recs)} record(s) total")
    return 0


def cmd_stale(args: argparse.Namespace) -> int:
    recs = list(_records_of(args))
    machine = args.machine or machine_fingerprint()
    known = {(r.phase, r.region) for r in recs}
    have = {(r.phase, r.region) for r in recs if r.machine == machine}
    stale = sorted(known - have)
    if args.phase:
        stale = [(p, r) for p, r in stale if p == args.phase]
    for phase, region in stale:
        d = _describe(region)
        mesh = f" mesh={d['mesh']}" if d and d["mesh"] else ""
        print(f"stale: {phase} {region}{mesh}")
    print(f"{len(stale)} stale region(s) for {machine} "
          f"({len(have)} tuned, {len(known)} known fleet-wide)")
    return 1 if stale and args.fail_on_stale else 0


def cmd_export(args: argparse.Namespace) -> int:
    store = _open_store(args)
    n = store.export(args.out, machine=args.machine or "all",
                     phase=args.phase)
    print(f"exported {n} record(s) -> {args.out}")
    return 0


def cmd_merge(args: argparse.Namespace) -> int:
    store = _open_store(args)
    stats = store.merge_records(read_records_file(args.db),
                                prefer=args.prefer)
    print(f"merged {args.db} -> {store.workdir} [{store.backend_name}]: "
          f"{stats['added']} added, {stats['updated']} updated, "
          f"{stats['kept']} kept")
    return 0


def cmd_promote(args: argparse.Namespace) -> int:
    recs = list(_open_store(args).records())
    if args.phase:
        recs = [r for r in recs if r.phase == args.phase]
    existing = read_records_file(args.db) if os.path.exists(args.db) else []
    index = {r.key: r for r in existing}
    added = updated = kept = 0
    for rec in recs:
        cur = index.get(rec.key)
        if cur is None:
            index[rec.key] = rec
            added += 1
        elif prefer_incoming(cur, rec, args.prefer):
            index[rec.key] = rec
            updated += 1
        else:
            kept += 1
    write_records_file(args.db, list(index.values()))
    print(f"promoted {store_desc(args)} -> {args.db}: {added} added, "
          f"{updated} updated, {kept} kept ({len(index)} golden)")
    return 0


def store_desc(args: argparse.Namespace) -> str:
    return f"{args.workdir} [{args.backend}]"


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def _add_common(p: argparse.ArgumentParser, *, machine_default_all=False):
    p.add_argument("--workdir", default=".",
                   help="tuning-DB workdir (default: cwd)")
    p.add_argument("--backend", default="jsonl",
                   help="record backend for --workdir (jsonl | sqlite)")
    p.add_argument("--machine", default="all" if machine_default_all
                   else None,
                   help="machine fingerprint to scope to ('all' = every "
                        "machine; default: %(default)s, None = live "
                        "fingerprint)")
    p.add_argument("--phase", default=None,
                   help="restrict to one phase (install | static | "
                        "dynamic)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.at",
        description="tuning-DB fleet operations (list / stale / export / "
                    "merge / promote)")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("list", help="enumerate records per phase and mesh")
    _add_common(p, machine_default_all=True)
    p.add_argument("--db", default=None,
                   help="read a golden DB file instead of --workdir")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("stale", help="regions tuned elsewhere but not "
                                     "for this fingerprint")
    _add_common(p)
    p.add_argument("--db", default=None,
                   help="read a golden DB file instead of --workdir")
    p.add_argument("--fail-on-stale", action="store_true",
                   help="exit 1 when stale regions exist (CI gating)")
    p.set_defaults(fn=cmd_stale)

    p = sub.add_parser("export", help="dump records to a golden DB file")
    _add_common(p, machine_default_all=True)
    p.add_argument("--out", required=True,
                   help="golden DB path (.sqlite/.db → sqlite, else "
                        "JSONL)")
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("merge", help="import a golden DB into a workdir")
    _add_common(p)
    p.add_argument("--db", required=True, help="golden DB file to import")
    p.add_argument("--prefer", default="better-cost",
                   choices=("better-cost", "incoming", "existing"),
                   help="key-collision policy (default: %(default)s)")
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser("promote", help="merge a workdir's winners into a "
                                       "golden DB (better cost wins)")
    _add_common(p, machine_default_all=True)
    p.add_argument("--db", required=True,
                   help="golden DB file to promote into (created if "
                        "missing)")
    p.add_argument("--prefer", default="better-cost",
                   choices=("better-cost", "incoming", "existing"),
                   help="key-collision policy (default: %(default)s)")
    p.set_defaults(fn=cmd_promote)
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
