"""The port's source lint (``pixie_tpu_torch/analysis/lint.py``) against
the JAX package's (``pixie_tpu/analysis/lint.py``).

Every case of ``tests/test_pxlint.py`` for the rules ported unchanged
(and the host-sync cases, whose fixtures use calls both rule sets flag)
runs with its ``run_lint`` calls answered by both engines, which must
give the same findings, baselined findings, suppression count and file
count. The port's lint over ``pixie_tpu/`` gives the JAX lint's findings
for the five rules ported unchanged. The retargeted ``host-sync-hot-path``
has cases of its own (torch's syncs), the hot regions the port registers
each name a function of the port, and the gate ``python -m
pixie_tpu_torch.analysis.lint`` exits 0 over ``pixie_tpu_torch/`` with
the port's baseline, ``metrics-naming`` finding nothing there at all.
"""

from __future__ import annotations

import ast
import fnmatch
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from pixie_tpu.analysis import lint as jax_lint
from pixie_tpu_torch.analysis import lint

REPO = Path(__file__).resolve().parent.parent

#: The rules whose code is the JAX package's, unchanged.
UNCHANGED = ("thread-shared-state", "lock-order", "request-from-handler",
             "blocking-call-under-lock", "metrics-naming")


def _load_jax_cases():
    spec = importlib.util.spec_from_file_location(
        "_jax_pxlint_cases", REPO / "tests" / "test_pxlint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CASES = _load_jax_cases()
#: The JAX cases over synthetic sources. Left out: the jit rule (not
#: ported) and the two over the JAX tree with the JAX baseline (their
#: port counterparts are below).
CASES = sorted(
    n for n in dir(JAX_CASES)
    if n.startswith("test_") and n not in (
        "test_jit_recompile_rule", "test_repo_lints_clean_with_baseline",
        "test_repo_metrics_naming_has_no_findings_at_all")
)


def _key(f):
    return (f.rule, f.path, f.line, f.message, f.symbol)


def _same_report(got, want):
    assert [_key(f) for f in got.findings] == [_key(f) for f in want.findings]
    assert sorted(_key(f) for f in got.baselined) == sorted(
        _key(f) for f in want.baselined)
    assert (got.suppressed, got.files, got.ok) == (
        want.suppressed, want.files, want.ok)


@pytest.mark.parametrize("case", CASES)
def test_jax_case_gives_equal_findings(case, tmp_path, monkeypatch):
    runs = []

    def both(paths, rules=None, baseline_path=None, repo_root=None):
        want = jax_lint.run_lint(paths, rules=rules,
                                 baseline_path=baseline_path,
                                 repo_root=repo_root)
        got = lint.run_lint(paths, rules=rules, baseline_path=baseline_path,
                            repo_root=repo_root)
        _same_report(got, want)
        runs.append(len(want.findings))
        return want

    monkeypatch.setattr(JAX_CASES, "run_lint", both)
    getattr(JAX_CASES, case)(tmp_path)
    assert runs


def test_case_list_covers_every_unchanged_rule():
    names = " ".join(CASES)
    for key in ("thread_shared_state", "lock_order", "request_from_handler",
                "blocking_rule", "metrics", "suppression", "baseline",
                "host_sync"):
        assert key in names, key
    assert {r().name for r in lint.ALL_RULES} == set(UNCHANGED) | {
        "host-sync-hot-path"}
    assert {r().name for r in jax_lint.ALL_RULES} - {
        r().name for r in lint.ALL_RULES} == {"jit-recompile-hazard"}
    assert lint.METRIC_RE.pattern == jax_lint.METRIC_RE.pattern
    assert lint.RESERVED_SUFFIXES == jax_lint.RESERVED_SUFFIXES


def test_port_lint_over_the_jax_tree_equals_jax_lint():
    """The five unchanged rules over ``pixie_tpu/`` without a baseline:
    the same findings and suppressions from both engines."""
    kw = dict(rules=set(UNCHANGED), baseline_path=os.devnull,
              repo_root=str(REPO))
    got = lint.run_lint([str(REPO / "pixie_tpu")], **kw)
    want = jax_lint.run_lint([str(REPO / "pixie_tpu")], **kw)
    _same_report(got, want)
    assert [f.rule for f in want.findings] == ["thread-shared-state"]


def test_port_baseline_roundtrip(tmp_path):
    """The counted baseline with the port's own save/load: line shifts
    keep an entry, a second occurrence of its key fails."""
    src = textwrap.dedent("""
        def setup(reg):
            reg.counter("Legacy-Metric", "grandfathered")
    """)
    p = tmp_path / "legacy.py"
    p.write_text(src)
    bl = tmp_path / "baseline.json"
    kw = dict(rules={"metrics-naming"}, baseline_path=str(bl),
              repo_root=str(tmp_path))
    r1 = lint.run_lint([str(p)], **kw)
    assert len(r1.findings) == 1
    lint.save_baseline(r1.findings, str(bl))
    assert lint.load_baseline(str(bl)) == jax_lint.load_baseline(str(bl))
    assert lint.run_lint([str(p)], **kw).ok
    p.write_text("\n\n" + src)
    assert lint.run_lint([str(p)], **kw).ok
    p.write_text(src + '    reg.counter("Legacy-Metric", "again")\n')
    r4 = lint.run_lint([str(p)], **kw)
    assert len(r4.findings) == 1 and len(r4.baselined) == 1


# -- host-sync-hot-path, retargeted to torch ----------------------------------


def _lint_src(tmp_path, src, extra_files=()):
    (tmp_path / "hot_mod.py").write_text(textwrap.dedent(src))
    for name, fsrc in extra_files:
        (tmp_path / name).write_text(textwrap.dedent(fsrc))
    return lint.run_lint([str(tmp_path)], rules={"host-sync-hot-path"},
                         baseline_path=os.devnull, repo_root=str(tmp_path))


TORCH_SYNCS = """
import numpy as np
import torch
from torch import cuda

PXLINT_HOT_REGIONS = ("hot_mod.py:Runner._loop*",)

class Runner:
    def _loop(self, xs, stream, event):
        for x in xs:
            a = x.item()
            b = x.tolist()
            c = x.cpu()
            d = x.numpy()
            e = np.asarray(x)
            torch.cuda.synchronize()
            cuda.synchronize()
            stream.synchronize()
            event.synchronize()
            x.block_until_ready()
        return a, b, c, d, e

    def _loop_fine(self, x, dev):
        y = x.cpu(memory_format=None)   # arguments: not the bare form
        z = x.item(0)
        w = x.numpy(force=True)
        v = x.to(dev, non_blocking=True)
        u = jax.device_get(x)           # not a torch sync
        return y, z, w, v, u

    def cold(self, x):
        torch.cuda.synchronize()        # not a hot region
        return x.item()
"""


def test_host_sync_flags_each_torch_sync(tmp_path):
    report = _lint_src(tmp_path, TORCH_SYNCS)
    got = [(f.line, f.message) for f in report.findings]
    assert [m for _l, m in got] == [
        ".item() forces a device-to-host readback inside hot region",
        ".tolist() forces a device-to-host readback inside hot region",
        ".cpu() forces a device-to-host copy inside hot region",
        ".numpy() forces a host readback inside hot region",
        "np.asarray() on a device value forces a host readback inside "
        "hot region",
        "torch.cuda.synchronize() forces a device sync inside hot region",
        "torch.cuda.synchronize() forces a device sync inside hot region",
        "synchronize() on a stream or event forces a device sync inside "
        "hot region",
        "synchronize() on a stream or event forces a device sync inside "
        "hot region",
        "block_until_ready() forces a device sync inside hot region",
    ]
    assert {f.symbol for f in report.findings} == {"Runner._loop"}
    assert [ln for ln, _m in got] == list(range(11, 21))


def test_host_sync_suppression_with_reason(tmp_path):
    report = _lint_src(tmp_path, """
        PXLINT_HOT_REGIONS = ("hot_mod.py:fold",)

        def fold(xs, flag):
            # The overflow flag must reach the host before the refold.
            n = flag.item()  # pxlint: disable=host-sync-hot-path

            return [x.tolist() for x in xs], n
        """)
    assert [f.message.split()[0] for f in report.findings] == [".tolist()"]
    assert report.suppressed == 1


def test_host_sync_nested_def_and_cross_module_registration(tmp_path):
    report = _lint_src(tmp_path, """
        PXLINT_HOT_REGIONS = ("worker.py:fold",)
        """, extra_files=[("worker.py", """
        def fold(xs):
            def stage(x):
                return x.cpu()  # one violation, one finding
            return [stage(x) for x in xs]

        def other(x):
            return x.cpu()
        """)])
    assert [(f.path, f.symbol) for f in report.findings] == [
        ("worker.py", "fold")]


def test_known_registrar_is_read_when_linting_one_file():
    """Linting a single engine file still sees the regions
    ``exec/pipeline.py`` registers (``_KNOWN_REGISTRARS``)."""
    assert lint._KNOWN_REGISTRARS == ("pixie_tpu_torch/exec/pipeline.py",)
    rule = lint.HostSyncHotPathRule()
    path = REPO / "pixie_tpu_torch" / "exec" / "engine.py"
    ctx = lint.FileCtx(str(path), "pixie_tpu_torch/exec/engine.py",
                       path.read_text())
    rule.prepare([ctx], str(REPO))
    assert ("exec/engine.py", "Engine._fold_agg_state") in rule.regions
    assert rule._hot_globs(ctx.relpath)


def test_every_registered_region_names_a_function_of_the_port():
    from pixie_tpu_torch.exec.pipeline import PXLINT_HOT_REGIONS

    assert PXLINT_HOT_REGIONS
    for entry in PXLINT_HOT_REGIONS:
        suffix, glob = entry.split(":", 1)
        path = REPO / "pixie_tpu_torch" / suffix
        ctx = lint.FileCtx(str(path), suffix, path.read_text())
        names = [ctx.qualname(n) for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
        assert any(fnmatch.fnmatch(n, glob) for n in names), entry
    jax_suffixes = {e.split(":")[0] for e in _jax_window_regions()}
    assert jax_suffixes <= {e.split(":")[0] for e in PXLINT_HOT_REGIONS}


def _jax_window_regions():
    """The JAX package's registrations for the window path, the join
    drivers and the telemetry fold (its ``pipeline.py`` lines 61-76)."""
    path = REPO / "pixie_tpu" / "exec" / "pipeline.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "PXLINT_HOT_REGIONS"
                for t in node.targets):
            regions = ast.literal_eval(node.value)
    return [e for e in regions if e.split(":")[0] in (
        "exec/pipeline.py", "exec/engine.py", "exec/joins.py",
        "services/telemetry.py")]


# -- the port's tree is green -------------------------------------------------


def test_port_lints_clean_with_its_baseline():
    report = lint.run_lint([str(REPO / "pixie_tpu_torch")],
                           repo_root=str(REPO))
    assert report.ok, "\n".join(f.render() for f in report.findings)
    assert [(f.rule, f.symbol) for f in report.baselined] == [
        ("thread-shared-state", "QueryBroker._abort_streams_of")]
    with open(lint.default_baseline_path()) as f:
        assert [e["path"] for e in json.load(f)["findings"]] == [
            "pixie_tpu_torch/services/query_broker.py"]


def test_port_metrics_naming_has_no_findings_at_all():
    report = lint.run_lint([str(REPO / "pixie_tpu_torch")],
                           rules={"metrics-naming"},
                           baseline_path=os.devnull, repo_root=str(REPO))
    assert report.findings == [] and report.suppressed == 0


def _gate(*argv, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, "-m", "pixie_tpu_torch.analysis.lint", *argv],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=120)


def test_gate_exits_zero_over_the_port(tmp_path):
    res = _gate(cwd=tmp_path)  # the default path is the port's tree
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 finding(s), 1 baselined" in res.stderr
    res = _gate("--json", "--rules", "metrics-naming,lock-order")
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout)
    assert out["findings"] == [] and out["files"] > 100


def test_gate_options_like_tools_pxlint(tmp_path):
    res = _gate("--list-rules")
    assert res.returncode == 0
    assert [ln.split(":")[0] for ln in res.stdout.splitlines()] == [
        r().name for r in lint.ALL_RULES]
    assert _gate("--rules", "jit-recompile-hazard").returncode == 2
    assert _gate("--update-baseline", "--rules",
                 "lock-order").returncode == 2
    bad = tmp_path / "bad.py"
    bad.write_text('def f(reg):\n    reg.counter("Bad-Name", "x")\n')
    res = _gate(str(bad), "--baseline", os.devnull)
    assert res.returncode == 1
    assert "metrics-naming" in res.stdout
    bl = tmp_path / "bl.json"
    res = _gate("--update-baseline", "--baseline", str(bl))
    assert res.returncode == 0, res.stderr
    assert lint.load_baseline(str(bl)) == lint.load_baseline(None)


def test_lint_module_imports_neither_torch_nor_the_linted_modules(tmp_path):
    code = (
        "import importlib.util, sys\n"
        f"p = {str(REPO / 'pixie_tpu_torch' / 'analysis' / 'lint.py')!r}\n"
        "spec = importlib.util.spec_from_file_location('_l', p)\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "sys.modules['_l'] = m\n"
        "spec.loader.exec_module(m)\n"
        f"r = m.run_lint([{str(REPO / 'pixie_tpu_torch')!r}], "
        f"repo_root={str(REPO)!r})\n"
        "assert r.ok\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'pixie_tpu', 'pixie_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path))
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
