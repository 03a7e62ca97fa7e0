"""The metrics-name lint's dynamic half (``tests/test_metrics_lint.py``)
on the port.

Every metric the port's engine stack registers (a query through the
trace spine, the engine collector, a render), and every name in the
port's default registry, follows Prometheus naming as the JAX package's
lint defines it (``^pixie_[a-z0-9_]+$``, valid label names, known kinds,
no histogram suffix on another kind), and every exposition line parses.
Both packages' exercised registries run the same query over the same
seeded table, and the port registers every name the JAX stack does.
The policy is the port's own copy (``pixie_tpu_torch.analysis.lint``),
held equal to the JAX one; the static half is the ``metrics-naming``
rule in ``tests/test_torch_pxlint.py``.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

from pixie_tpu.analysis import lint as jax_lint
from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.exec.trace import Tracer as JaxTracer
from pixie_tpu.services import observability as jax_obs
from pixie_tpu_torch.analysis.lint import METRIC_RE, RESERVED_SUFFIXES
from pixie_tpu_torch.exec import Engine
from pixie_tpu_torch.exec.trace import Tracer
from pixie_tpu_torch.services import observability as port_obs

LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
VALID_KINDS = {"counter", "gauge", "histogram"}
QUERY = (
    "import px\ndf = px.DataFrame(table='t')\n"
    "df = df.groupby('k').agg(n=('v', px.count))\npx.display(df)\n"
)


def _exercised_registry(pkg: str):
    """A registry holding everything the engine stack registers."""
    obs = jax_obs if pkg == "jax" else port_obs
    reg = obs.MetricsRegistry()
    if pkg == "jax":
        eng = JaxEngine(window_rows=1 << 10)
        eng.tracer = JaxTracer(registry=reg)
    else:
        eng = Engine(window_rows=1 << 10, device="cpu")
        eng.tracer = Tracer(registry=reg)
    n = 3000
    eng.append_data("t", {
        "time_": np.arange(n, dtype=np.int64),
        "k": np.arange(n, dtype=np.int64) % 5,
        "v": np.arange(n, dtype=np.int64),
    })
    eng.execute_query(QUERY)
    reg.register_collector(obs.engine_collector(eng))
    reg.render()  # collectors register their gauges here
    return reg


def test_naming_policy_equals_jax():
    assert METRIC_RE.pattern == jax_lint.METRIC_RE.pattern
    assert tuple(RESERVED_SUFFIXES) == tuple(jax_lint.RESERVED_SUFFIXES)


def test_registered_metric_names_follow_convention():
    reg = _exercised_registry("port")
    metrics = list(reg._metrics.values())
    assert len(metrics) >= 8  # tracer + collector surface actually ran
    for m in metrics:
        assert METRIC_RE.match(m.name), (
            f"metric {m.name!r} violates ^pixie_[a-z0-9_]+$"
        )
        assert m.kind in VALID_KINDS, f"{m.name}: unknown kind {m.kind!r}"
        # Base names must not collide with histogram series suffixes.
        if m.kind != "histogram":
            assert not m.name.endswith(RESERVED_SUFFIXES), (
                f"{m.name}: reserved Prometheus suffix on a {m.kind}"
            )
        for labels in m.values:
            for k, _v in labels:
                assert LABEL_RE.match(k), f"{m.name}: bad label {k!r}"
                assert k != "le", f"{m.name}: 'le' is histogram-reserved"
    jax_names = {m.name: m.kind
                 for m in _exercised_registry("jax")._metrics.values()}
    port_names = {m.name: m.kind for m in metrics}
    missing = {n: k for n, k in jax_names.items() if port_names.get(n) != k}
    assert not missing, missing


def test_default_registry_names_follow_convention():
    for name in port_obs.default_registry._metrics:
        assert METRIC_RE.match(name), (
            f"default_registry metric {name!r} violates ^pixie_[a-z0-9_]+$"
        )


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_exposition_parses_as_prometheus_text(pkg):
    """Every rendered line is a comment or ``name{labels} value``."""
    reg = _exercised_registry(pkg)
    line_re = re.compile(
        r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
        r"[-+]?([0-9.]+([eE][-+]?[0-9]+)?|inf|nan)$"
    )
    for line in reg.render().splitlines():
        if not line or line.startswith("#"):
            continue
        assert line_re.match(line), f"unparseable exposition line: {line!r}"
