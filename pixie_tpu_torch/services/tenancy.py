"""Tenant model for broker overload protection.

Reference parity: the source system isolates tenants at the control
plane — Vizier's query broker serves many independent dashboard users
through one admission point, and a noisy tenant's burst must queue
behind *its own* backlog, not everyone's. This module is the identity
half of that contract: a **registered tenant set** with per-tenant
weights (``admission_tenant_weights`` flag), a resolver that folds any
unregistered tenant string into the shared default tenant, and the
budget-share arithmetic weighted-fair admission (``_Admission`` in
``services/query_broker.py``) schedules on.

Why a registered set: tenant names label Prometheus series
(``pixie_admission_{queued,shed,rejected}_total{tenant=...}``) and
telemetry-table columns. Labeling with raw client-supplied strings
would make series cardinality unbounded — a self-inflicted overload of
the observability plane while defending the query plane. The runtime
guard is :func:`resolve_tenant` (unknown -> ``shared``, counted once
in the unlabeled ``pixie_admission_unknown_tenant_total``); the static
guard is the ``metrics-naming`` pxlint rule, which rejects
``.labels(tenant=...)`` call sites whose value does not come from a
resolver-derived binding (docs/ANALYSIS.md).
"""

from __future__ import annotations

from ..config import get_flag

#: Every query without an explicit (registered) tenant runs as this
#: tenant — existing callers keep working unchanged, sharing one
#: default slice of the admission budget.
DEFAULT_TENANT = "shared"


#: Memoized parse of the weights spec, keyed on the raw flag string:
#: tenant_weights() runs on hot paths — per metric increment, per
#: served request, and per _schedule_locked pass UNDER the admission
#: lock — and the spec is effectively constant. Benign data race on
#: rebind (worst case: a redundant parse); callers must treat the
#: returned dict as read-only.
_WEIGHTS_MEMO: "tuple[str, dict[str, float]] | None" = None


def tenant_weights() -> dict[str, float]:
    """{tenant: weight} from ``admission_tenant_weights`` ("a:2,b:1").

    The default tenant is always present (weight 1.0 unless listed
    explicitly), so unregistered traffic always has a slice. A missing
    or malformed weight parses as 1.0; negative weights clamp to 0
    (a tenant an operator wants OFF still stays a registered name, so
    its traffic is identifiable rather than folded into ``shared``).
    Returns a shared memoized dict — do not mutate.
    """
    global _WEIGHTS_MEMO
    spec = str(get_flag("admission_tenant_weights")).strip()
    memo = _WEIGHTS_MEMO
    if memo is not None and memo[0] == spec:
        return memo[1]
    out: dict[str, float] = {}
    if spec:
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            name, _, w = entry.partition(":")
            name = name.strip()
            if not name:
                continue
            try:
                weight = float(w) if w.strip() else 1.0
            except ValueError:
                weight = 1.0
            out[name] = max(weight, 0.0)
    out.setdefault(DEFAULT_TENANT, 1.0)
    _WEIGHTS_MEMO = (spec, out)
    return out


def resolve_tenant(name, count_unknown: bool = True) -> str:
    """Fold ``name`` into the registered tenant set.

    Registered names pass through; empty/None/unregistered names
    resolve to :data:`DEFAULT_TENANT`. This is the bounded-cardinality
    guard: every tenant string that reaches a metric label or a
    telemetry column went through here first. ``count_unknown=False``
    skips the unknown-tenant counter — for resolution points UPSTREAM
    of the one that owns the count (the served front door resolves for
    worker accounting before execute_script resolves the same request
    for admission; counting both would double every served unknown).
    """
    if not name:
        return DEFAULT_TENANT
    name = str(name)
    if name in tenant_weights():
        return name
    if count_unknown:
        from .observability import default_counter

        default_counter(
            "pixie_admission_unknown_tenant_total",
            "Queries whose tenant was not in the registered set "
            "(admission_tenant_weights) and ran as the shared tenant",
        ).inc()
    return DEFAULT_TENANT


def tenant_shares(budget: float) -> dict[str, float]:
    """{tenant: byte share} — ``budget`` split by registered weight.

    Shares partition the budget (they sum to it), so per-tenant
    accounting alone bounds the global in-flight sum: an over-share
    tenant queues behind its own backlog while an under-share tenant's
    admission decision never even reads the other tenants' state.
    """
    weights = tenant_weights()
    total = sum(weights.values()) or 1.0
    return {t: budget * w / total for t, w in weights.items()}
