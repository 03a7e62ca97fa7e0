"""px-style command-line client.

Reference parity: ``src/pixie_cli`` (the ``px`` binary:
``px run <script>``, ``px script list``, ``px get viziers`` ...). The
transport is the framed-TCP netbus to a broker running ``serve()``
(VizierService.ExecuteScript analog); ``--local`` runs scripts against
an in-process engine instead (useful for replays and development).

Usage:
  python -m pixie_tpu_torch.cli run px/http_stats [--broker HOST:PORT]
  python -m pixie_tpu_torch.cli run my_query.pxl --local --replay events.npz
  python -m pixie_tpu_torch.cli script list | script show px/http_stats
  python -m pixie_tpu_torch.cli explain px/http_stats
  python -m pixie_tpu_torch.cli tables|agents --broker HOST:PORT
  python -m pixie_tpu_torch.cli debug queries --broker HOST:PORT [-v]
  python -m pixie_tpu_torch.cli profile --broker HOST:PORT [--diff A B]
  python -m pixie_tpu_torch.cli cancel QID --broker HOST:PORT
  python -m pixie_tpu_torch.cli docs

A port of the JAX package's ``cli.py``. ``run --local`` runs its engine on
the CUDA card unless ``PIXIE_TPU_TORCH_DEVICE`` names another device
(``cpu`` for tests); without a card and without that variable it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_query(name_or_path: str) -> str:
    from .scripts import list_scripts, load_script

    if name_or_path in list_scripts():
        return load_script(name_or_path).pxl
    if os.path.exists(name_or_path):
        with open(name_or_path) as f:
            return f.read()
    raise SystemExit(
        f"no script named {name_or_path!r} (library: "
        f"{', '.join(list_scripts())}) and no such file"
    )


def _print_batch(name: str, hb, fmt: str) -> None:
    d = hb.to_pydict()
    cols = list(d)
    if fmt == "json":
        rows = [
            {c: _py(d[c][i]) for c in cols} for i in range(hb.length)
        ]
        print(json.dumps({"table": name, "rows": rows}))
        return
    if fmt == "csv":
        # The reference's CSV surface (carnot_executable.cc CSV-out /
        # `px run -o csv`): header then rows, stdlib-quoted. Each table
        # is prefixed with a `# table: <name>` comment line so
        # multi-output scripts stay parseable (split on the marker).
        import csv as _csv

        print(f"# table: {name}")
        w = _csv.writer(sys.stdout, lineterminator="\n")
        w.writerow(cols)
        for i in range(hb.length):
            w.writerow([_py(d[c][i]) for c in cols])
        return
    widths = {
        c: max(len(c), *(len(str(v)) for v in d[c][:200]), 1) if hb.length else len(c)
        for c in cols
    }
    print(f"== {name} ({hb.length} rows) ==")
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for i in range(min(hb.length, 200)):
        print("  ".join(str(_py(d[c][i])).ljust(widths[c]) for c in cols))
    if hb.length > 200:
        print(f"... {hb.length - 200} more rows")


def _py(v):
    from .api import _py as api_py

    return api_py(v)


def _client(addr: str):
    from .api import Client

    host, _, port = addr.rpartition(":")
    return Client(host or "127.0.0.1", int(port))


def cmd_run(args) -> int:
    query = _load_query(args.script)
    if args.broker:
        from .api import ScriptExecutionError

        req = {"query": query, "timeout_s": args.timeout,
               "max_output_rows": args.max_rows}
        if args.require_complete:
            req["require_complete"] = True
        if args.tenant:
            req["tenant"] = args.tenant
        if args.priority:
            req["priority"] = args.priority
        if args.deadline_ms:
            req["deadline_ms"] = args.deadline_ms
        with _client(args.broker) as client:
            try:
                res = client._request(
                    "broker.execute", req, timeout_s=args.timeout + 5,
                )
            except ScriptExecutionError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
        for name, hb in sorted(res["tables"].items()):
            _print_batch(name, hb, args.output)
        if res.get("partial"):
            reasons = res.get("missing_reasons", {})
            if set(reasons.values()) <= {"deadline", "cancelled"} and reasons:
                why = "/".join(sorted(set(reasons.values())))
                # Keys are agent ids except the broker's "_query"
                # sentinel (query stopped with no agent outstanding).
                agents = sorted(k for k in reasons if not k.startswith("_"))
                suffix = f" ({', '.join(agents)})" if agents else ""
                print(
                    f"warning: PARTIAL results — query {why} before "
                    f"completion{suffix}",
                    file=sys.stderr,
                )
            else:
                missing = ", ".join(res.get("missing_agents", []))
                print(
                    f"warning: PARTIAL results — data agent(s) lost "
                    f"mid-query: {missing}",
                    file=sys.stderr,
                )
        if args.output == "table":
            stats = res.get("agent_stats", {})
            if stats:
                worst = max(s["exec_time_s"] for s in stats.values())
                print(f"[{len(stats)} agents, slowest {worst * 1e3:.1f}ms]")
        return 0
    if not args.local:
        print(
            "error: no target — pass --broker HOST:PORT for a cluster "
            "or --local for an in-process engine",
            file=sys.stderr,
        )
        return 2
    # Local mode: one in-process engine over replays, on the card unless
    # the device variable names another.
    from .deploy import DEVICE_ENV, env_device
    from .exec.engine import Engine
    from .ingest.schemas import init_schemas

    try:
        device = env_device()
    except (RuntimeError, ValueError) as e:
        print(f"error: {e} ({DEVICE_ENV}=cpu runs it on the CPU)",
              file=sys.stderr)
        return 1
    eng = Engine(device=device)
    init_schemas(eng)
    if args.synthetic:
        from .ingest.replay import replay_into

        replay_into(eng, args.synthetic)
    for path in args.replay or []:
        from .ingest.replay import load_npz

        for records in load_npz(path):
            eng.append_data("http_events", records)
    out = eng.execute_query(query, max_output_rows=args.max_rows)
    for name, hb in sorted(out.items()):
        _print_batch(name, hb, args.output)
    return 0


def cmd_live(args) -> int:
    """Live view: subscribe to a streaming query, reprinting the result
    as it updates (the reference UI's live-view flow over StreamResults)
    until interrupted or --rounds updates have arrived."""
    import threading

    query = _load_query(args.script)
    done = threading.Event()
    seen = {"n": 0, "failed": False}

    def on_update(u):
        if "error" in u:
            print(f"error: {u['error']}", file=sys.stderr)
            seen["failed"] = True
            done.set()
            return
        if u.get("stream_degraded"):
            missing = ", ".join(u.get("missing_agents", []))
            print(
                f"warning: live view degraded — {u.get('reason', '')} "
                f"(missing: {missing})",
                file=sys.stderr,
            )
            return
        seen["n"] += 1
        mode = u.get("mode", "")
        print(f"-- update {seen['n']} ({mode}) --")
        rows = u["rows"]
        cols = list(rows)
        for i in range(len(rows[cols[0]]) if cols else 0):
            print({c: rows[c][i] for c in cols})
        if args.rounds and seen["n"] >= args.rounds:
            done.set()

    with _client(args.broker) as client:
        sub = client.stream_script(
            query, on_update, poll_interval_s=args.interval,
            require_complete=args.require_complete or None,
        )
        try:
            done.wait(timeout=args.timeout if args.timeout else None)
        except KeyboardInterrupt:
            pass
        finally:
            sub.cancel()
    return 1 if seen["failed"] else 0


def cmd_script(args) -> int:
    from .scripts import list_scripts, load_script

    if args.action == "list":
        for n in list_scripts():
            s = load_script(n)
            print(f"{n:28s} {s.manifest.get('short', '')}")
        return 0
    if not args.name:
        print("usage: px script show <name>", file=sys.stderr)
        return 2
    s = load_script(args.name)
    print(s.pxl)
    return 0


def cmd_explain(args) -> int:
    from .planner.debug import explain_pxl
    from .types.dtypes import DataType
    from .types.relation import Relation

    query = _load_query(args.script)
    if args.broker:
        with _client(args.broker) as client:
            schemas = client.schemas()
    else:
        # Offline explain: synthesize schemas for the canonical tables the
        # script references (shipped output-table relations).
        from .ingest.schemas import CANONICAL_SCHEMAS

        schemas = dict(CANONICAL_SCHEMAS)
        schemas.setdefault(
            "t", Relation([("time_", DataType.TIME64NS)])
        )
    print(explain_pxl(query, schemas))
    return 0


def cmd_tables(args) -> int:
    with _client(args.broker) as client:
        schemas = client.schemas()
    for name, rel in sorted(schemas.items()):
        print(f"{name}: {rel}")
    return 0


def cmd_agents(args) -> int:
    with _client(args.broker) as client:
        status = client.agents_status()
    agents = status["agents"]
    if status.get("broker"):
        # Broker HA: WHICH replica answered (the current leader).
        print(f"broker: {status['broker']}")
    for a in agents:
        q = "  QUARANTINED" if a.get("quarantined") else ""
        print(
            f"{a['agent_id']:14s} asid={a['asid']:<4d} {a['kind']:6s} "
            f"hb={a['last_heartbeat_s']:.1f}s tables={a['num_tables']}{q}"
        )
    return 0


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TB"


def _fmt_lag(ms) -> str:
    ms = float(ms or 0.0)
    if ms <= 0:
        return "-"
    if ms < 1000:
        return f"{ms:.0f}ms"
    if ms < 3600_000:
        return f"{ms / 1000:.1f}s"
    return f"{ms / 3600_000:.1f}h"


def cmd_debug(args) -> int:
    """`px debug queries`: recent query traces from the broker with
    per-query resource usage and per-agent attribution (the self-
    observability surface — docs/OBSERVABILITY.md)."""
    with _client(args.broker) as client:
        res = client.debug_queries(limit=args.limit)
    rows = res["queries"]
    if args.output == "json":
        print(json.dumps(res, default=str))
        return 0
    if not rows and not res["in_flight"]:
        print("no recent queries")
        return 0
    hdr = (f"{'qid':12s} {'tenant':8s} {'status':8s} {'cache':6s} "
           f"{'ms':>9s} "
           f"{'rows':>9s} {'staged':>9s} {'pred':>9s} {'pred/obs':>8s} "
           f"{'device':>9s} {'wire':>9s} {'fresh':>9s} agents")
    print(hdr)
    for row in res["in_flight"] + rows:
        u = row.get("usage", {})
        agents = sorted(row.get("agent_usage", {}))
        # pxbound predicted staged bytes next to the observed column —
        # the admission-control signal, auditable per query (a observed
        # > predicted row is a soundness bug; see docs/ANALYSIS.md).
        pred = row.get("predicted") or {}
        pb = pred.get("bytes_staged_hi")
        # Calibration ratio: how far the plan-time prediction over-
        # shoots reality (>= 1 is pxbound's soundness contract; huge =
        # the over-conservatism the observed floor narrows). Blank when
        # either side is unknown — a sketch-less prediction, a fully
        # device-resident run with zero staged bytes — or when the
        # "prediction" IS observed history (origin contains
        # "observed"): that number is yesterday's max, not a pxbound
        # bound, and a < 1 ratio there is growth, not unsoundness.
        obs = u.get("bytes_staged", 0)
        floored = "observed" in str(pred.get("origin", ""))
        ratio = (
            f"{pb / obs:.2f}" if pb is not None and obs and not floored
            else "-"
        )
        print(
            f"{row.get('qid') or row['id'][:12]:12s} "
            f"{row.get('tenant', '-') or '-':8s} "
            f"{row['status']:8s} "
            # Result-cache disposition ("-" = cache not in play).
            f"{row.get('cache') or '-':6s} "
            f"{row['duration_ms']:>9.1f} "
            f"{row.get('rows_out', u.get('rows_out', 0)):>9d} "
            f"{_fmt_bytes(u.get('bytes_staged', 0)):>9s} "
            f"{'-' if pb is None else _fmt_bytes(pb):>9s} "
            f"{ratio:>8s} "
            f"{u.get('device_ms', 0.0):>8.1f}ms "
            f"{_fmt_bytes(u.get('wire_bytes', 0)):>9s} "
            # Result staleness: worst scanned-table watermark lag at
            # execute time ("-" = no time-indexed scan recorded).
            f"{_fmt_lag(u.get('freshness_lag_ms', 0.0)):>9s} "
            f"{','.join(agents)}"
        )
        if args.verbose:
            for aid, au in sorted(row.get("agent_usage", {}).items()):
                print(
                    f"  {aid:14s} staged={_fmt_bytes(au.get('bytes_staged', 0))} "
                    f"device={au.get('device_ms', 0.0):.1f}ms "
                    f"wire={_fmt_bytes(au.get('wire_bytes', 0))} "
                    f"rows={au.get('rows_out', 0)} "
                    f"windows={au.get('windows', 0)}"
                )
    return 0


def cmd_profile(args) -> int:
    """`px profile`: cluster-merged CPU flames from the broker —
    agents' heartbeat folded-stack summaries plus the broker's own
    sampler, attributed with qid/script hash/tenant/phase. ``--diff A
    B`` renders the per-frame differential profile between two script
    hashes (services/telemetry.py profile_diff)."""
    from .services.telemetry import profile_counts, profile_diff

    with _client(args.broker) as client:
        if args.diff:
            base_hash, cmp_hash = args.diff
            base = client.profile(
                agent=args.agent, tenant=args.tenant,
                script=base_hash, limit=4096,
            )["stacks"]
            cmp_ = client.profile(
                agent=args.agent, tenant=args.tenant,
                script=cmp_hash, limit=4096,
            )["stacks"]
            rows = profile_diff(
                profile_counts(base), profile_counts(cmp_)
            )[:args.limit]
            if args.output == "json":
                print(json.dumps(rows))
                return 0
            print(f"{'frame':48s} {'self Δ':>8s} {'self a':>7s} "
                  f"{'self b':>7s} {'total Δ':>8s}")
            for r in rows:
                print(
                    f"{r['frame'][:48]:48s} {r['self_delta']:>+8d} "
                    f"{r['self_base']:>7d} {r['self_cmp']:>7d} "
                    f"{r['total_delta']:>+8d}"
                )
            return 0
        res = client.profile(
            agent=args.agent, tenant=args.tenant,
            script=args.script, limit=args.limit,
        )
    if args.output == "json":
        print(json.dumps(res))
        return 0
    stacks = res["stacks"]
    if not stacks:
        print("no profile samples (is self_profiling on?)")
        return 0
    print(f"agents: {', '.join(res['agents']) or '-'}")
    print(f"{'samples':>8s} {'tenant':8s} {'phase':12s} "
          f"{'script':12s} stack (leaf last)")
    for r in stacks:
        stack = r["stack"]
        if args.output == "collapsed":
            print(f"{stack} {r['count']}")
            continue
        frames = stack.split(";")
        tail = ";".join(frames[-3:]) if len(frames) > 3 else stack
        print(
            f"{r['count']:>8d} {r.get('tenant') or '-':8s} "
            f"{r.get('phase') or '-':12s} "
            f"{(r.get('script_hash') or '-')[:12]:12s} "
            f"{'...' if len(frames) > 3 else ''}{tail}"
        )
    return 0


def cmd_cancel(args) -> int:
    """`px cancel <qid>`: cooperative cancellation — the broker stops
    the query's agents at their next window boundary and the original
    caller gets a partial result (reason "cancelled")."""
    with _client(args.broker) as client:
        if client.cancel_query(args.qid):
            print(f"query {args.qid} cancelled")
            return 0
    print(f"no running query {args.qid!r}", file=sys.stderr)
    return 1


def cmd_docs(args) -> int:
    from .metadata.funcs import register_metadata_funcs
    from .metadata.state import MetadataState
    from .udf.docgen import generate_markdown
    from .udf.registry import default_registry

    # Include the metadata family (bound to an empty state): `px docs >
    # docs/FUNCTIONS.md` must regenerate the committed reference exactly.
    reg = default_registry().clone("docs")
    register_metadata_funcs(reg, MetadataState())
    print(generate_markdown(reg))
    return 0


def cmd_version(args) -> int:
    from .version import version_info

    print(json.dumps(version_info(), indent=1))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="px", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="execute a PxL script")
    run.add_argument("script", help="library script name or .pxl path")
    run.add_argument("--broker", help="broker netbus HOST:PORT")
    run.add_argument("--local", action="store_true", help="in-process engine")
    run.add_argument("--replay", action="append",
                     help="saved http_events replay .npz (local)")
    run.add_argument("--synthetic", type=int, metavar="N",
                     help="generate an N-row synthetic replay (local)")
    run.add_argument("--timeout", type=float, default=30.0)
    run.add_argument("--max-rows", type=int, default=10_000)
    run.add_argument("--require-complete", action="store_true",
                     help="fail instead of returning partial results "
                          "when a data agent is lost mid-query")
    run.add_argument("--tenant",
                     help="tenant to admit the query under (registered "
                          "via admission_tenant_weights; unknown names "
                          "run as the shared tenant)")
    run.add_argument("--priority", type=int, default=0,
                     help="admission-queue priority (higher first)")
    run.add_argument("--deadline-ms", type=float, default=0.0,
                     help="query deadline: shed while queued / abort "
                          "cooperatively once dispatched, returning "
                          "partial results")
    run.add_argument("-o", "--output", choices=("table", "json", "csv"),
                     default="table")
    run.set_defaults(fn=cmd_run)

    cn = sub.add_parser(
        "cancel", help="cooperatively cancel a running query by qid"
    )
    cn.add_argument("qid")
    cn.add_argument("--broker", required=True)
    cn.set_defaults(fn=cmd_cancel)

    lv = sub.add_parser("live", help="subscribe to a live (streaming) view")
    lv.add_argument("script", help="library script name or .pxl path")
    lv.add_argument("--broker", required=True, help="broker netbus HOST:PORT")
    lv.add_argument("--interval", type=float, default=0.5,
                    help="agent poll cadence (seconds)")
    lv.add_argument("--rounds", type=int, default=0,
                    help="stop after N updates (0 = until interrupted)")
    lv.add_argument("--require-complete", action="store_true",
                    help="abort the live view instead of degrading "
                         "when a data agent is lost")
    lv.add_argument("--timeout", type=float, default=0.0,
                    help="stop after this many seconds (0 = none)")
    lv.set_defaults(fn=cmd_live)

    sc = sub.add_parser("script", help="script library")
    sc.add_argument("action", choices=("list", "show"))
    sc.add_argument("name", nargs="?")
    sc.set_defaults(fn=cmd_script)

    ex = sub.add_parser("explain", help="render a script's physical plan")
    ex.add_argument("script")
    ex.add_argument("--broker", help="use live schemas from this broker")
    ex.set_defaults(fn=cmd_explain)

    tb = sub.add_parser("tables", help="list cluster table schemas")
    tb.add_argument("--broker", required=True)
    tb.set_defaults(fn=cmd_tables)

    ag = sub.add_parser("agents", help="list live agents")
    ag.add_argument("--broker", required=True)
    ag.set_defaults(fn=cmd_agents)

    db = sub.add_parser(
        "debug", help="self-observability surfaces (debug queries)"
    )
    db.add_argument("what", choices=("queries",),
                    help="queries: recent query traces + resource usage")
    db.add_argument("--broker", required=True)
    db.add_argument("--limit", type=int, default=20)
    db.add_argument("-v", "--verbose", action="store_true",
                    help="per-agent usage breakdown under each query")
    db.add_argument("-o", "--output", choices=("table", "json"),
                    default="table")
    db.set_defaults(fn=cmd_debug)

    pf = sub.add_parser(
        "profile",
        help="cluster-merged CPU flames (top folded stacks, attributed)",
    )
    pf.add_argument("--broker", required=True)
    pf.add_argument("--agent", default=None,
                    help="only this agent's stacks (default: cluster merge)")
    pf.add_argument("--tenant", default=None,
                    help="only samples attributed to this tenant")
    pf.add_argument("--script", default=None, metavar="HASH",
                    help="only samples attributed to this script hash")
    pf.add_argument("--diff", nargs=2, metavar=("BASE", "CMP"),
                    help="differential profile between two script hashes")
    pf.add_argument("-n", "--limit", type=int, default=20)
    pf.add_argument("-o", "--output",
                    choices=("table", "json", "collapsed"), default="table")
    pf.set_defaults(fn=cmd_profile)

    dc = sub.add_parser("docs", help="dump the function reference (markdown)")
    dc.set_defaults(fn=cmd_docs)

    vr = sub.add_parser("version", help="print build/version metadata")
    vr.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
