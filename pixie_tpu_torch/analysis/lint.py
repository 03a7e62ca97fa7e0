"""pxlint: a reusable AST-rule engine with concurrency- and
device-sync-aware rules, over the port's tree.

A port of the JAX package's ``analysis/lint.py`` (which
``tools/pxlint.py`` drives over ``pixie_tpu/``). Rules are pure AST
visitors: this module imports neither torch nor the linted modules, so
linting never executes device code. ``python -m
pixie_tpu_torch.analysis.lint [paths] [--rules r1,r2] [--baseline PATH]
[--update-baseline] [--json] [--list-rules]`` lints ``pixie_tpu_torch/``
by default against ``pixie_tpu_torch/analysis/baseline.json`` and exits
non-zero on any finding that is neither suppressed nor baselined.

Rules:

- ``host-sync-hot-path``: nothing that makes the host wait for the card
  inside registered hot regions (the per-window execution path): no
  ``.item()``, ``.tolist()``, ``.cpu()`` or ``.numpy()`` without
  arguments, no ``np.asarray``, no ``torch.cuda.synchronize`` and no
  ``.synchronize()`` on a stream or an event (nor
  ``block_until_ready``, the port's ``DeviceResult`` fence). A host sync
  per window serializes the pipelined executor (``exec/pipeline.py``):
  the prefetch thread's copies and the card's folds stop overlapping.
  Hot regions are *registered* by the modules that own them via a
  module-level ``PXLINT_HOT_REGIONS = ("path-suffix:qualname-glob",
  ...)`` assignment (``exec/pipeline.py`` registers the window path).
- ``thread-shared-state``: an attribute mutated both from a thread
  context (``Thread(target=...)`` entry methods and bus
  ``subscribe`` callbacks, transitively through same-class calls) and
  from a public method, with at least one side not holding a lock.
- ``lock-order``: whole-tree interprocedural lock-acquisition graph —
  ``with self.<lock>`` nesting tracked transitively through same-class
  ``self.m()`` calls and cross-module ``self.attr.m()`` calls (attr
  types inferred from ``self.attr = ClassName(...)`` assignments); any
  cycle in the (class, lock-attr) order graph is a potential deadlock,
  reported with both acquisition chains. Re-acquiring a non-reentrant
  lock already held on the path (directly or through a call chain) is
  a certain self-deadlock and is reported too.
- ``request-from-handler``: a bus ``subscribe`` callback that
  (transitively through same-class calls and nested defs) issues a
  blocking ``bus.request``/``RemoteBus.request`` — the dispatcher
  thread blocks for the reply, and if the responder (or the reply
  inbox) is served by this same dispatcher the handler self-deadlocks
  until the timeout.
- ``blocking-call-under-lock``: ``bus.request``, ``block_until_ready``,
  ``.item()``, ``time.sleep`` or a queue get/put without a timeout made
  while a ``with self.<lock>`` is held.
- ``metrics-naming``: metric names registered via
  ``.counter/.gauge/.histogram`` must match ``^pixie_[a-z0-9_]+$``
  and must not end in a Prometheus histogram-series suffix.

The JAX package's ``jit-recompile-hazard`` rule is not ported: the port
has no ``jax.jit`` and does not use ``torch.compile``.

Suppression: append ``# pxlint: disable=<rule>[,<rule>...]`` to the
offending line (or the line directly above). Known findings live in
``pixie_tpu_torch/analysis/baseline.json``, counted per (rule, path,
symbol, message): a key whose occurrences grow fails.
"""

from __future__ import annotations

import ast
import fnmatch
import json
import os
import re
from dataclasses import dataclass, field

_SUPPRESS_RE = re.compile(r"#\s*pxlint:\s*disable=([A-Za-z0-9_,\- ]+)")
_HOT_REGION_ATTR = "PXLINT_HOT_REGIONS"
# Metric-name policy — the single source for both the static rule here
# and the dynamic registration checks in tests/test_metrics_lint.py.
METRIC_RE = re.compile(r"^pixie_[a-z0-9_]+$")
RESERVED_SUFFIXES = ("_bucket", "_sum", "_count")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    symbol: str  # enclosing qualname ("<module>" at top level)

    def key(self) -> tuple:
        """Baseline identity: line numbers drift, these don't."""
        return (self.rule, self.path, self.symbol, self.message)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message} " \
               f"[{self.symbol}]"


class FileCtx:
    """One parsed file: AST with parent/qualname info + suppressions."""

    def __init__(self, path: str, relpath: str, source: str):
        self.path = path
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.suppress: dict[int, set] = {}
        for i, line in enumerate(source.splitlines(), start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                self.suppress[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
        self._qual: dict[int, str] = {}  # id(node) -> qualname
        self._annotate(self.tree, [])

    def _annotate(self, node, stack):
        for child in ast.iter_child_nodes(node):
            self._qual[id(child)] = ".".join(stack) or "<module>"
            named = isinstance(
                child,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            )
            if named:
                stack.append(child.name)
            self._annotate(child, stack)
            if named:
                stack.pop()

    def qualname(self, node) -> str:
        """Qualname of the scope CONTAINING node (for a def node, its
        own dotted name)."""
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            outer = self._qual.get(id(node), "<module>")
            return node.name if outer == "<module>" else \
                f"{outer}.{node.name}"
        return self._qual.get(id(node), "<module>")

    def suppressed(self, rule: str, line: int) -> bool:
        for ln in (line, line - 1):
            rules = self.suppress.get(ln)
            if rules and (rule in rules or "all" in rules):
                return True
        return False


#: Modules known to register hot regions, parsed even when the lint
#: path set does not include them (linting a single edited file must
#: not silently turn the host-sync rule into a no-op).
_KNOWN_REGISTRARS = ("pixie_tpu_torch/exec/pipeline.py",)


def _hot_regions(ctxs, repo_root=None) -> list[tuple[str, str]]:
    """Collect (path-suffix, qualname-glob) hot-region registrations
    from every scanned module's ``PXLINT_HOT_REGIONS`` assignment,
    plus the known registrar modules under ``repo_root``."""
    ctxs = list(ctxs)
    scanned = {ctx.relpath for ctx in ctxs}
    if repo_root:
        for rel in _KNOWN_REGISTRARS:
            if rel in scanned:
                continue
            path = os.path.join(repo_root, rel)
            try:
                with open(path) as f:
                    ctxs.append(FileCtx(path, rel, f.read()))
            except (OSError, SyntaxError, UnicodeDecodeError):
                continue
    regions: list[tuple[str, str]] = []
    for ctx in ctxs:
        for node in ctx.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            if not any(
                isinstance(t, ast.Name) and t.id == _HOT_REGION_ATTR
                for t in node.targets
            ):
                continue
            try:
                entries = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                continue
            for e in entries:
                if isinstance(e, str) and ":" in e:
                    suffix, glob = e.split(":", 1)
                    regions.append((suffix, glob))
    return regions


# -- rule: host-sync-hot-path -------------------------------------------------

#: Tensor methods that, called without arguments, copy a device tensor to
#: the host and so wait for every queued kernel that writes it.
_READBACK_METHODS = {
    "item": ".item() forces a device-to-host readback",
    "tolist": ".tolist() forces a device-to-host readback",
    "cpu": ".cpu() forces a device-to-host copy",
    "numpy": ".numpy() forces a host readback",
}


def _is_torch_cuda(node) -> bool:
    """``torch.cuda`` (or a bare ``cuda`` imported from torch)."""
    if isinstance(node, ast.Name):
        return node.id == "cuda"
    return (
        isinstance(node, ast.Attribute) and node.attr == "cuda"
        and isinstance(node.value, ast.Name) and node.value.id == "torch"
    )


class HostSyncHotPathRule:
    name = "host-sync-hot-path"
    description = (
        "no .item()/.tolist()/.cpu()/.numpy()/np.asarray/"
        "torch.cuda.synchronize/.synchronize()/block_until_ready inside "
        "registered hot regions (PXLINT_HOT_REGIONS)"
    )

    def __init__(self):
        self.regions: list[tuple[str, str]] = []

    def prepare(self, ctxs, repo_root=None):
        self.regions = _hot_regions(ctxs, repo_root)

    def _hot_globs(self, relpath: str) -> list[str]:
        # Anchored at a path-component boundary: "somexec/engine.py"
        # must not match the "exec/engine.py" registration.
        return [
            g for suffix, g in self.regions
            if relpath == suffix or relpath.endswith("/" + suffix)
        ]

    def check(self, ctx: FileCtx):
        globs = self._hot_globs(ctx.relpath)
        if not globs:
            return
        scanned: list[str] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            qn = ctx.qualname(node)
            if not any(fnmatch.fnmatch(qn, g) for g in globs):
                continue
            # A nested def inside an already-scanned hot function was
            # covered by the enclosing scan (ast.walk descends into
            # nested bodies) — scanning it again would double-report.
            if any(qn.startswith(outer + ".") for outer in scanned):
                continue
            scanned.append(qn)
            yield from self._check_fn(ctx, node, qn)

    def _check_fn(self, ctx, fn, qn):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            msg = None
            if isinstance(f, ast.Attribute):
                bare = not node.args and not node.keywords
                if f.attr in _READBACK_METHODS and bare:
                    msg = _READBACK_METHODS[f.attr]
                elif (
                    f.attr == "asarray"
                    and isinstance(f.value, ast.Name)
                    and f.value.id in ("np", "numpy", "onp")
                ):
                    msg = ("np.asarray() on a device value forces a "
                           "host readback")
                elif f.attr == "synchronize" and _is_torch_cuda(f.value):
                    msg = "torch.cuda.synchronize() forces a device sync"
                elif f.attr == "synchronize":
                    msg = ("synchronize() on a stream or event forces a "
                           "device sync")
                elif f.attr == "block_until_ready":
                    msg = "block_until_ready() forces a device sync"
            if msg:
                yield Finding(
                    rule=self.name,
                    path=ctx.relpath,
                    line=node.lineno,
                    message=f"{msg} inside hot region",
                    symbol=qn,
                )


# -- rule: thread-shared-state ------------------------------------------------

_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                         "BoundedSemaphore"})

#: Method calls that mutate their receiver in place (self.x.append(...)
#: is a write to self.x just as much as self.x = ... is).
_MUTATOR_METHODS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault",
    "pop", "popitem", "remove", "discard", "clear",
})


@dataclass
class _AttrWrite:
    attr: str
    line: int
    locked: bool
    method: str


@dataclass
class _ClassInfo:
    name: str
    qualname: str
    methods: dict = field(default_factory=dict)  # name -> FunctionDef
    lock_attrs: set = field(default_factory=set)
    thread_entries: set = field(default_factory=set)  # method names
    # method -> nested defs used as thread targets/callbacks
    nested_thread_bodies: dict = field(default_factory=dict)
    calls: dict = field(default_factory=dict)  # method -> {self.m called}
    writes: dict = field(default_factory=dict)  # method -> [_AttrWrite]


def _self_attr(node) -> str | None:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _class_lock_attrs(cls: ast.ClassDef) -> set:
    """``self.X`` attributes assigned a Lock/RLock/Condition/Semaphore
    anywhere in the class body (shared by thread-shared-state and
    blocking-call-under-lock)."""
    out: set = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            vf = node.value.func
            ctor = (
                vf.attr if isinstance(vf, ast.Attribute)
                else vf.id if isinstance(vf, ast.Name) else None
            )
            if ctor in _LOCK_CTORS:
                for t in node.targets:
                    a = _self_attr(t)
                    if a:
                        out.add(a)
    return out


class ThreadSharedStateRule:
    name = "thread-shared-state"
    description = (
        "attribute mutated from both a thread context (Thread target / "
        "bus subscribe callback) and a public method without a lock"
    )

    def prepare(self, ctxs, repo_root=None):
        pass

    def check(self, ctx: FileCtx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(ctx, node)

    # -- per-class analysis ---------------------------------------------------
    def _check_class(self, ctx: FileCtx, cls: ast.ClassDef):
        info = _ClassInfo(name=cls.name, qualname=ctx.qualname(cls))
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.methods[item.name] = item
        # Pass 1: lock attrs from EVERY method, so a lock assigned in a
        # textually-later method (e.g. __init__ not first in the class
        # body) still counts when earlier methods' writes are scanned.
        info.lock_attrs = _class_lock_attrs(cls)
        for name, fn in info.methods.items():
            self._scan_method(info, name, fn)

        # Each Thread target / bus subscription runs on its OWN
        # dispatcher thread (services/msgbus.py Subscription), so two
        # different entry roots = two concurrent threads. Compute, per
        # method, which entry roots can reach it through same-class
        # self.m() calls.
        method_roots: dict[str, set] = {}
        for entry in info.thread_entries:
            seen = {entry}
            frontier = [entry]
            while frontier:
                m = frontier.pop()
                method_roots.setdefault(m, set()).add(entry)
                for callee in info.calls.get(m, ()):
                    if callee in info.methods and callee not in seen:
                        seen.add(callee)
                        frontier.append(callee)

        threaded = set(method_roots)
        public = {
            m for m in info.methods
            if not m.startswith("_") and m not in threaded
        }

        by_attr: dict[str, dict] = {}
        for m, writes in info.writes.items():
            side = (
                "thread" if m in threaded
                else "public" if m in public
                else None
            )
            if side is None:
                continue
            for w in writes:
                by_attr.setdefault(
                    w.attr, {"thread": [], "public": []}
                )[side].append(w)

        for attr, sides in sorted(by_attr.items()):
            tw, pw = sides["thread"], sides["public"]
            t_unlocked = [w for w in tw if not w.locked]
            p_unlocked = [w for w in pw if not w.locked]
            t_roots = set()
            for w in tw:
                t_roots |= method_roots.get(w.method, set())
            # Hazard 1: written by a thread AND a public (caller-thread)
            # method, with at least one side not holding a lock.
            hazard = tw and pw and (t_unlocked or p_unlocked)
            detail = "thread context and public method"
            # Hazard 2: unlocked writes reachable from two DIFFERENT
            # thread entries — two dispatcher threads racing each other.
            if not hazard and len(t_roots) >= 2 and t_unlocked:
                hazard = True
                detail = "two different dispatcher threads"
            if not hazard:
                continue
            t_m = sorted({x.method for x in tw})
            p_m = sorted({x.method for x in pw})
            writers = ", ".join(t_m + p_m)
            # One finding PER unlocked write: suppressing one site (the
            # engine applies `# pxlint: disable` per line) must not
            # hide a future unlocked write to the same attribute.
            for w in t_unlocked + p_unlocked:
                yield Finding(
                    rule=self.name,
                    path=ctx.relpath,
                    line=w.line,
                    message=(
                        f"attribute self.{attr} is written from "
                        f"{detail} ({writers}) with at least one write "
                        "not holding a lock"
                    ),
                    symbol=f"{info.qualname}.{w.method}",
                )

    def _scan_method(self, info: _ClassInfo, name: str, fn):
        writes: list[_AttrWrite] = []
        calls: set = set()
        nested_defs = {
            n.name: n for n in ast.walk(fn)
            if isinstance(n, ast.FunctionDef) and n is not fn
        }
        thread_nested: set = set()

        def register_target(arg):
            a = _self_attr(arg)
            if a is not None:
                info.thread_entries.add(a)
            elif isinstance(arg, ast.Name) and arg.id in nested_defs:
                thread_nested.add(arg.id)
            elif isinstance(arg, ast.Call):
                # Wrapped handler: subscribe(t, guard(self._on_x)) /
                # subscribe(t, _guarded(_on_execute)) — the wrapped
                # callable still runs on the dispatcher thread.
                for inner in list(arg.args) + [
                    kw.value for kw in arg.keywords
                ]:
                    register_target(inner)

        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                # threading.Thread(target=...) / Thread(target=...)
                is_thread = (
                    isinstance(f, ast.Name) and f.id == "Thread"
                ) or (isinstance(f, ast.Attribute) and f.attr == "Thread")
                if is_thread:
                    for kw in node.keywords:
                        if kw.arg == "target":
                            register_target(kw.value)
                # bus.subscribe(topic, self._on_x): callbacks run on the
                # subscription's dispatcher thread (services/msgbus.py)
                if isinstance(f, ast.Attribute) and f.attr == "subscribe":
                    for arg in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        register_target(arg)
                # self.m(...) intra-class call graph
                a = _self_attr(f)
                if a is not None:
                    calls.add(a)

        self._collect_writes(info, name, fn, writes, under_lock=False)
        info.calls[name] = calls
        info.writes[name] = writes
        for nd in thread_nested:
            # Writes inside a nested thread body count as thread-side.
            nwrites: list = []
            self._collect_writes(
                info, name, nested_defs[nd], nwrites, under_lock=False
            )
            key = f"{name}.<{nd}>"
            info.writes[key] = nwrites
            info.calls[key] = set()
            info.nested_thread_bodies[key] = nd
            # the nested body may call self.m too
            for node in ast.walk(nested_defs[nd]):
                if isinstance(node, ast.Call):
                    a = _self_attr(node.func)
                    if a is not None:
                        info.calls[key].add(a)
            info.thread_entries.add(key)

    def _collect_writes(self, info, method, node, out, under_lock):
        """Record self.X writes, tracking `with self.<lock>:` scopes."""
        if isinstance(node, ast.With):
            locked = under_lock or any(
                _self_attr(item.context_expr) in info.lock_attrs
                or (
                    isinstance(item.context_expr, ast.Call)
                    and _self_attr(item.context_expr.func) in info.lock_attrs
                )
                for item in node.items
            )
            for child in node.body:
                self._collect_writes(info, method, child, out, locked)
            return
        if isinstance(node, ast.Assign):
            for t in node.targets:
                self._note_write(info, method, t, node.lineno, under_lock,
                                 out)
        elif isinstance(node, ast.AugAssign):
            self._note_write(info, method, node.target, node.lineno,
                             under_lock, out)
        elif isinstance(node, ast.Call):
            # Container mutation anywhere (statement or expression):
            # self.x.append(...) / h = self.x.pop(k, None) / ...
            f = node.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _MUTATOR_METHODS
            ):
                self._note_write(info, method, f.value, node.lineno,
                                 under_lock, out)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested defs handled separately
            self._collect_writes(info, method, child, out, under_lock)

    def _note_write(self, info, method, target, line, locked, out):
        attr = _self_attr(target)
        # Subscript writes (self.x[k] = v) count against self.x too.
        if attr is None and isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
        if attr is None or attr in info.lock_attrs:
            return
        out.append(_AttrWrite(attr=attr, line=line, locked=locked,
                              method=method))


# -- rule: lock-order ---------------------------------------------------------

#: Lock constructors that are reentrant for the acquiring thread. A bare
#: ``Condition()`` wraps a fresh RLock; ``Condition(self._lock)`` takes
#: the wrapped lock's reentrancy (aliased in ``_LockClassInfo``).
_REENTRANT_CTORS = frozenset({"RLock"})


@dataclass
class _LockClassInfo:
    name: str
    relpath: str
    qualname: str
    bases: list = field(default_factory=list)  # simple base-class names
    lock_ctors: dict = field(default_factory=dict)  # attr -> ctor name
    # Condition(self._x) shares _x's underlying lock: both attrs are ONE
    # lock node in the order graph.
    lock_aliases: dict = field(default_factory=dict)  # attr -> attr
    attr_types: dict = field(default_factory=dict)  # attr -> class name
    # method -> [(held, kind, data, line)]: held = ((attr, line), ...)
    # for this method's enclosing `with self.<attr>` scopes; kind is
    # "acquire" (data = attr) or "call" (data = ("self", m) |
    # ("attr", (attr, m))).
    methods: dict = field(default_factory=dict)


def _parse_lock_class(ctx: "FileCtx", cls: ast.ClassDef) -> _LockClassInfo:
    info = _LockClassInfo(
        name=cls.name, relpath=ctx.relpath, qualname=ctx.qualname(cls),
    )
    for b in cls.bases:
        if isinstance(b, ast.Name):
            info.bases.append(b.id)
        elif isinstance(b, ast.Attribute):
            info.bases.append(b.attr)
    for node in ast.walk(cls):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        vf = node.value.func
        ctor = (
            vf.attr if isinstance(vf, ast.Attribute)
            else vf.id if isinstance(vf, ast.Name) else None
        )
        if ctor is None:
            continue
        for t in node.targets:
            a = _self_attr(t)
            if a is None:
                continue
            if ctor in _LOCK_CTORS:
                info.lock_ctors[a] = ctor
                if ctor == "Condition" and node.value.args:
                    wrapped = _self_attr(node.value.args[0])
                    if wrapped is not None:
                        info.lock_aliases[a] = wrapped
            elif ctor[:1].isupper():
                # Type inference seed: self.X = ClassName(...).
                info.attr_types.setdefault(a, ctor)
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            actions: list = []
            _scan_lock_actions(item, (), actions)
            info.methods[item.name] = actions
            _infer_param_attr_types(item, info.attr_types)
    return info


def _ann_name(ann) -> str | None:
    """Simple class name from an annotation node ('Engine',
    'exec.engine.Engine', '"Engine"', 'Engine | None')."""
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1].strip() or None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _ann_name(ann.left) or _ann_name(ann.right)
    if isinstance(ann, ast.Subscript):  # Optional[X]
        return _ann_name(ann.slice)
    return None


def _infer_param_attr_types(fn, attr_types: dict) -> None:
    """``self.X = param`` where the param carries a class annotation
    (and ``self.X: Cls = ...``) seed the cross-module call resolution —
    the ``self.bus = bus`` constructor-injection idiom."""
    params = {}
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        name = _ann_name(a.annotation) if a.annotation is not None else None
        if name is not None and name[:1].isupper():
            params[a.arg] = name
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name):
            t = params.get(node.value.id)
            if t is None:
                continue
            for tgt in node.targets:
                a = _self_attr(tgt)
                if a is not None:
                    attr_types.setdefault(a, t)
        elif isinstance(node, ast.AnnAssign):
            a = _self_attr(node.target)
            t = _ann_name(node.annotation)
            if a is not None and t is not None and t[:1].isupper():
                attr_types.setdefault(a, t)


def _scan_lock_actions(node, held, out):
    """Collect acquire/call actions with the enclosing held-lock set.
    ``held`` is a tuple of (attr, line) for ``with self.<attr>`` scopes
    currently open in THIS method (filtered to real lock attrs later)."""
    if isinstance(node, ast.With):
        inner = held
        for item in node.items:
            _scan_lock_actions(item.context_expr, inner, out)
            a = _self_attr(item.context_expr)
            if a is not None:
                out.append((inner, "acquire", a, item.context_expr.lineno))
                inner = inner + ((a, item.context_expr.lineno),)
        for child in node.body:
            _scan_lock_actions(child, inner, out)
        return
    if isinstance(node, ast.Call):
        f = node.func
        a = _self_attr(f)
        if a is not None:
            out.append((held, "call", ("self", a), node.lineno))
        elif (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Attribute)
        ):
            recv = _self_attr(f.value)
            if recv is not None:
                out.append(
                    (held, "call", ("attr", (recv, f.attr)), node.lineno)
                )
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
            continue  # nested bodies run on a later call, not here
        _scan_lock_actions(child, held, out)


class LockOrderRule:
    """Whole-program lock-order verification.

    Nodes are (defining class, lock attr); an edge A -> B is recorded
    whenever code may acquire B while holding A — directly via nested
    ``with self.<lock>`` scopes, or transitively through same-class
    ``self.m()`` and typed cross-class ``self.attr.m()`` calls. A cycle
    means two threads taking the locks in opposite orders can deadlock;
    the diagnostic carries one acquisition chain per edge. Re-acquiring
    a held non-reentrant lock is reported as a certain self-deadlock.

    Static blind spots (covered by the runtime validator,
    ``analysis/lockdep.py``): locks stored in containers/locals,
    ``.acquire()`` calls without a ``with``, duck-typed receivers, and
    cross-instance aliasing of one class's lock attr."""

    name = "lock-order"
    description = (
        "cycle in the interprocedural (class, lock-attr) acquisition-"
        "order graph, or a held non-reentrant lock re-acquired on the "
        "same path — a potential deadlock"
    )

    def __init__(self):
        self._by_path: dict = {}

    # -- whole-program analysis (prepare) -------------------------------------
    def prepare(self, ctxs, repo_root=None):
        classes: dict[str, list] = {}
        for ctx in ctxs:
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.ClassDef):
                    classes.setdefault(node.name, []).append(
                        _parse_lock_class(ctx, node)
                    )
        self._classes = classes
        self._lockmap_memo: dict = {}
        self._methodmap_memo: dict = {}
        self._reach_memo: dict = {}
        edges: dict = {}  # (hkey, akey) -> evidence dict
        self_deadlocks: dict = {}  # dedup key -> finding
        for infos in classes.values():
            for info in infos:
                self._class_edges(info, edges, self_deadlocks)
        findings = list(self_deadlocks.values())
        findings.extend(self._cycle_findings(edges))
        self._by_path = {}
        for f in findings:
            self._by_path.setdefault(f.path, []).append(f)

    def check(self, ctx: FileCtx):
        yield from self._by_path.get(ctx.relpath, ())

    # -- class/attr resolution ------------------------------------------------
    def _resolve_class(self, name: str):
        infos = self._classes.get(name)
        # Ambiguous simple names (two modules, one class name) stay
        # unresolved: merging them would invent cross-module edges.
        return infos[0] if infos and len(infos) == 1 else None

    def _mro(self, info: _LockClassInfo) -> list:
        out, seen = [], set()
        frontier = [info]
        while frontier:
            c = frontier.pop(0)
            if id(c) in seen:
                continue
            seen.add(id(c))
            out.append(c)
            for b in c.bases:
                bc = self._resolve_class(b)
                if bc is not None:
                    frontier.append(bc)
        return out

    def _lockmap(self, info: _LockClassInfo) -> dict:
        """attr -> ((relpath, class, attr) node key, reentrant) over the
        class and its resolvable bases, own declarations first.
        ``Condition(self._x)`` aliases to ``_x``'s node (the two attrs
        are ONE underlying lock) — resolved through the MRO, so a
        subclass Condition wrapping a base-class lock still collapses
        onto the base lock's node and takes ITS reentrancy."""
        key = (info.relpath, info.qualname)
        hit = self._lockmap_memo.get(key)
        if hit is not None:
            return hit
        # attr -> (defining class, ctor, alias target) — own-first.
        decl: dict = {}
        for c in self._mro(info):
            for a, ctor in c.lock_ctors.items():
                if a not in decl:
                    decl[a] = (c, ctor, c.lock_aliases.get(a))
        out: dict = {}
        for a, (c, ctor, alias) in decl.items():
            if alias is not None and alias in decl:
                tc, tctor, _ = decl[alias]
                out[a] = (
                    (tc.relpath, tc.name, alias),
                    tctor in _REENTRANT_CTORS
                    or tctor == "Condition",  # bare Condition = RLock
                )
            else:
                # Own node. A bare Condition() wraps a fresh RLock
                # (reentrant); a Condition over an UNKNOWN lock (ctor
                # param, container) cannot be analyzed — treat as
                # reentrant so it never false-positives a self-nest.
                reentrant = (
                    ctor in _REENTRANT_CTORS or ctor == "Condition"
                )
                out[a] = ((c.relpath, c.name, a), reentrant)
        self._lockmap_memo[key] = out
        return out

    def _methodmap(self, info: _LockClassInfo) -> dict:
        key = (info.relpath, info.qualname)
        hit = self._methodmap_memo.get(key)
        if hit is not None:
            return hit
        out: dict = {}
        for c in self._mro(info):
            for m, actions in c.methods.items():
                out.setdefault(m, (c, actions))
        self._methodmap_memo[key] = out
        return out

    def _attr_type(self, info: _LockClassInfo, attr: str):
        for c in self._mro(info):
            t = c.attr_types.get(attr)
            if t is not None:
                return self._resolve_class(t)
        return None

    def _resolve_call(self, info: _LockClassInfo, data):
        """(receiver class info, method name) for a call action, or
        None when the receiver/method cannot be resolved statically."""
        kind, payload = data
        if kind == "self":
            return (info, payload) if payload in self._methodmap(info) \
                else None
        attr, m = payload
        target = self._attr_type(info, attr)
        if target is not None and m in self._methodmap(target):
            return (target, m)
        return None

    # -- interprocedural acquisition summaries --------------------------------
    def _reach(self, info: _LockClassInfo, method: str,
               stack: frozenset = frozenset()) -> dict:
        """{lock node key: (reentrant, chain)} of every lock a call to
        ``info.method`` may acquire, transitively. ``chain`` is a tuple
        of "Class.method" steps ending at the acquiring method."""
        key = (info.relpath, info.qualname, method)
        hit = self._reach_memo.get(key)
        if hit is not None:
            return hit
        if key in stack:
            return {}
        stack = stack | {key}
        entry = self._methodmap(info).get(method)
        if entry is None:
            return {}
        owner, actions = entry
        lm = self._lockmap(info)
        out: dict = {}
        step = f"{info.name}.{method}"
        for _held, kind, data, _line in actions:
            if kind == "acquire":
                node = lm.get(data)
                if node is not None:
                    out.setdefault(node[0], (node[1], (step,)))
            else:
                callee = self._resolve_call(info, data)
                if callee is None:
                    continue
                for k, (reent, chain) in self._reach(
                    callee[0], callee[1], stack
                ).items():
                    if k not in out and len(chain) < 8:
                        out[k] = (reent, (step,) + chain)
        self._reach_memo[key] = out
        return out

    # -- edge + finding generation --------------------------------------------
    @staticmethod
    def _lock_name(node_key) -> str:
        return f"{node_key[1]}.{node_key[2]}"

    def _class_edges(self, info, edges, self_deadlocks):
        lm = self._lockmap(info)
        for method, (owner, actions) in self._methodmap(info).items():
            symbol = f"{info.qualname}.{method}"
            for held, kind, data, line in actions:
                held_nodes = [
                    (lm[a][0], hl) for a, hl in held if a in lm
                ]
                if not held_nodes:
                    continue
                if kind == "acquire":
                    node = lm.get(data)
                    targets = (
                        {node[0]: (node[1], (f"{info.name}.{method}",))}
                        if node is not None else {}
                    )
                else:
                    callee = self._resolve_call(info, data)
                    if callee is None:
                        continue
                    targets = {
                        k: (reent,
                            (f"{info.name}.{method} -> "
                             f"{callee[0].name}.{callee[1]}",) + ch[1:])
                        for k, (reent, ch) in self._reach(
                            callee[0], callee[1]
                        ).items()
                    }
                for k, (reent, chain) in targets.items():
                    for h, _hline in held_nodes:
                        if h == k:
                            if reent:
                                continue
                            dk = (owner.relpath, symbol, k)
                            if dk not in self_deadlocks:
                                self_deadlocks[dk] = Finding(
                                    rule=self.name,
                                    path=owner.relpath,
                                    line=line,
                                    message=(
                                        f"non-reentrant lock "
                                        f"{self._lock_name(k)} re-"
                                        f"acquired while held (via "
                                        f"{' -> '.join(chain)}) — "
                                        "certain self-deadlock"
                                    ),
                                    symbol=symbol,
                                )
                            continue
                        edges.setdefault((h, k), {
                            "path": owner.relpath, "line": line,
                            "symbol": symbol, "chain": chain,
                        })

    def _cycle_findings(self, edges) -> list:
        adj: dict = {}
        for (h, k) in edges:
            adj.setdefault(h, set()).add(k)
        findings = []
        for cycle in self._cycles(adj):
            # Canonical rotation: start at the smallest node so the
            # finding (and its baseline key) is order-stable.
            i = cycle.index(min(cycle))
            cycle = cycle[i:] + cycle[:i]
            names = [self._lock_name(n) for n in cycle]
            parts = []
            for j, n in enumerate(cycle):
                nxt = cycle[(j + 1) % len(cycle)]
                ev = edges[(n, nxt)]
                parts.append(
                    f"{self._lock_name(n)} -> {self._lock_name(nxt)} "
                    f"via {' -> '.join(ev['chain'])}"
                )
            first = edges[(cycle[0], cycle[1 % len(cycle)])]
            findings.append(Finding(
                rule=self.name,
                path=first["path"],
                line=first["line"],
                message=(
                    "potential deadlock: lock-order cycle "
                    + " -> ".join(names + [names[0]])
                    + " [" + "; ".join(parts) + "]"
                ),
                symbol=first["symbol"],
            ))
        findings.sort(key=lambda f: (f.path, f.message))
        return findings

    @staticmethod
    def _cycles(adj) -> list:
        """One shortest cycle per strongly-connected component (Tarjan;
        fixing any edge of it re-exposes whatever remains)."""
        index: dict = {}
        low: dict = {}
        on: set = set()
        order: list = []
        sccs: list = []
        counter = [0]

        def strongconnect(v):
            work = [(v, iter(sorted(adj.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            order.append(v)
            on.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        order.append(w)
                        on.add(w)
                        work.append((w, iter(sorted(adj.get(w, ())))))
                        advanced = True
                        break
                    elif w in on:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    low[work[-1][0]] = min(low[work[-1][0]], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = order.pop()
                        on.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        sccs.append(set(scc))

        for v in sorted(adj):
            if v not in index:
                strongconnect(v)

        cycles = []
        for scc in sccs:
            # BFS from the smallest node back to itself inside the SCC.
            start = min(scc)
            parent = {start: None}
            frontier = [start]
            found = None
            while frontier and found is None:
                nxt = []
                for u in frontier:
                    for w in sorted(adj.get(u, ())):
                        if w == start:
                            found = u
                            break
                        if w in scc and w not in parent:
                            parent[w] = u
                            nxt.append(w)
                    if found is not None:
                        break
                frontier = nxt
            if found is None:
                continue
            path = [found]
            while parent[path[-1]] is not None:
                path.append(parent[path[-1]])
            cycles.append(list(reversed(path)))
        return cycles


# -- rule: request-from-handler -----------------------------------------------

def _bus_recv_name(f) -> str | None:
    """Receiver of a ``.request`` call when it looks like a message bus
    (``*bus`` / ``RemoteBus``) — shared with blocking-call-under-lock."""
    if not (isinstance(f, ast.Attribute) and f.attr == "request"):
        return None
    recv = f.value
    name = (
        recv.id if isinstance(recv, ast.Name)
        else recv.attr if isinstance(recv, ast.Attribute)
        else None
    )
    if name is not None and (
        name == "RemoteBus" or name.lstrip("_").endswith("bus")
    ):
        return name
    return None


class RequestFromHandlerRule:
    """A bus ``subscribe`` callback that issues a blocking
    ``bus.request`` (directly, through same-class ``self.m()`` calls,
    or through nested defs of the registering method). The callback
    runs on its subscription's dispatcher thread; ``request`` blocks
    that thread up to its timeout — and when the responder (or the
    one-shot reply inbox) is dispatched by the same thread, the handler
    deadlocks outright until the timeout (a netbus close-vs-read-loop
    race had this shape). Move the request onto a
    worker thread, or reply asynchronously."""

    name = "request-from-handler"
    description = (
        "blocking bus.request/RemoteBus.request reachable from a bus "
        "subscribe callback — the dispatcher thread blocks on a reply "
        "it may itself have to dispatch (self-deadlock shape)"
    )

    def prepare(self, ctxs, repo_root=None):
        pass

    def check(self, ctx: FileCtx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(ctx, node)

    def _check_class(self, ctx: FileCtx, cls: ast.ClassDef):
        methods = {
            item.name: item
            for item in cls.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        entries: list = []  # (entry label, start node kind)
        for mname, fn in methods.items():
            nested = {
                n.name: n for n in ast.walk(fn)
                if isinstance(n, ast.FunctionDef) and n is not fn
            }

            def register(arg, _m=mname, _nested=nested):
                a = _self_attr(arg)
                if a is not None:
                    entries.append((a, ("method", a)))
                elif isinstance(arg, ast.Name) and arg.id in _nested:
                    entries.append(
                        (f"{_m}.<{arg.id}>", ("nested", (_m, arg.id)))
                    )
                elif isinstance(arg, ast.Call):
                    for inner in list(arg.args) + [
                        kw.value for kw in arg.keywords
                    ]:
                        register(inner)

            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "subscribe"
                ):
                    for arg in list(node.args) + [
                        kw.value for kw in node.keywords
                    ]:
                        register(arg)
        if not entries:
            return
        reported: set = set()
        for label, start in entries:
            for site in self._reachable_requests(ctx, cls, methods, start):
                key = (site[0], site[1])
                if key in reported:
                    continue
                reported.add(key)
                yield Finding(
                    rule=self.name,
                    path=ctx.relpath,
                    line=site[0],
                    message=(
                        f"{site[2]}.request() blocks the subscribe "
                        f"callback {label!r}'s dispatcher thread "
                        "(self-deadlock if the reply routes through "
                        "this dispatcher) — move the request off the "
                        "handler"
                    ),
                    symbol=site[1],
                )

    @staticmethod
    def _walk_scoped(root):
        """Walk ``root``'s body WITHOUT descending into nested defs —
        a nested def's body runs only when CALLED (the explicit
        ``nested`` frontier models that), not where it is defined."""
        stack = list(ast.iter_child_nodes(root))
        while stack:
            n = stack.pop()
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            stack.extend(ast.iter_child_nodes(n))

    def _reachable_requests(self, ctx, cls, methods, start):
        """(line, symbol, recv) request sites reachable from ``start``
        through same-class self-calls and CALLED nested defs of the
        enclosing method (a nested def that is merely defined — e.g.
        handed to a worker thread — is not a dispatcher-thread site)."""
        sites: list = []
        seen: set = set()
        frontier = [start]
        while frontier:
            kind, payload = frontier.pop()
            if (kind, payload) in seen:
                continue
            seen.add((kind, payload))
            if kind == "method":
                mname = payload
                fn = methods.get(mname)
                if fn is None:
                    continue
                body, qual = fn, f"{ctx.qualname(cls)}.{mname}"
            else:
                mname, nname = payload
                fn = methods.get(mname)
                if fn is None:
                    continue
                body = next(
                    (n for n in ast.walk(fn)
                     if isinstance(n, ast.FunctionDef) and n is not fn
                     and n.name == nname),
                    None,
                )
                if body is None:
                    continue
                qual = f"{ctx.qualname(cls)}.{mname}.{nname}"
            nested_names = {
                n.name for n in ast.walk(fn)
                if isinstance(n, ast.FunctionDef) and n is not fn
            }
            for node in self._walk_scoped(body):
                if not isinstance(node, ast.Call):
                    continue
                recv = _bus_recv_name(node.func)
                if recv is not None:
                    sites.append((node.lineno, qual, recv))
                a = _self_attr(node.func)
                if a is not None and a in methods:
                    frontier.append(("method", a))
                elif (
                    isinstance(node.func, ast.Name)
                    and node.func.id in nested_names
                    and not (kind == "nested"
                             and node.func.id == payload[1])
                ):
                    frontier.append(("nested", (mname, node.func.id)))
        return sites


# -- rule: blocking-call-under-lock -------------------------------------------

class BlockingCallUnderLockRule:
    """Flag blocking calls made while a ``with self.<lock>:`` scope is
    held. ``bus.request`` / ``RemoteBus.request`` block up to their
    timeout waiting for a remote reply, and ``block_until_ready()`` /
    ``.item()`` fence the device — holding an instance lock across
    either serializes every other thread (bus dispatcher threads, the
    query thread) behind a network/device round trip, and a reply
    handler that needs the same lock deadlocks outright. Move the
    blocking call outside the critical section (snapshot state under
    the lock, call after)."""

    name = "blocking-call-under-lock"
    description = (
        "bus.request/block_until_ready/.item()/time.sleep/timeout-less "
        "queue get-put while holding a `with self.<lock>` — a blocking "
        "call inside a critical section (deadlock-prone; serializes "
        "other threads)"
    )

    def prepare(self, ctxs, repo_root=None):
        pass

    def check(self, ctx: FileCtx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(ctx, node)

    def _check_class(self, ctx: FileCtx, cls: ast.ClassDef):
        locks = _class_lock_attrs(cls)
        if not locks:
            return
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{ctx.qualname(cls)}.{item.name}"
                yield from self._scan(ctx, item, qn, locks, locked=False)

    def _scan(self, ctx, node, qn, locks, locked):
        if isinstance(node, ast.With):
            # Items evaluate in order, each after the previous item's
            # __enter__ — so a context expression AFTER a lock item (or
            # inside a nested `with` header under an outer lock) is a
            # held-lock call site too.
            held = locked
            for item in node.items:
                yield from self._scan(ctx, item.context_expr, qn, locks,
                                      held)
                if item.optional_vars is not None:
                    yield from self._scan(ctx, item.optional_vars, qn,
                                          locks, held)
                if (
                    _self_attr(item.context_expr) in locks
                    or (
                        isinstance(item.context_expr, ast.Call)
                        and _self_attr(item.context_expr.func) in locks
                    )
                ):
                    held = True
            for child in node.body:
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue  # defined, not called, under the lock
                yield from self._scan(ctx, child, qn, locks, held)
            return
        if locked and isinstance(node, ast.Call):
            msg = self._blocking_msg(node)
            if msg:
                yield Finding(
                    rule=self.name,
                    path=ctx.relpath,
                    line=node.lineno,
                    message=f"{msg} while holding a lock",
                    symbol=qn,
                )
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # A nested def does not RUN here; its body executes on
                # whatever thread later calls it (scanned unlocked via
                # the class walk only if it's a method — nested-def
                # bodies under a lock are not held-lock call sites).
                continue
            yield from self._scan(ctx, child, qn, locks, locked)

    @staticmethod
    def _blocking_msg(node: ast.Call) -> str | None:
        f = node.func
        if not isinstance(f, ast.Attribute):
            return None
        # bus.request / self.bus.request / self._bus.request /
        # RemoteBus.request — the message-bus request/reply round trip.
        # Receiver must look like a bus so `requests`-style libraries
        # don't false-positive.
        bus = _bus_recv_name(f)
        if bus is not None:
            return f"{bus}.request() (blocks up to its timeout)"
        if f.attr == "block_until_ready":
            return "block_until_ready() (device fence)"
        if f.attr == "item" and not node.args:
            return ".item() (device-to-host readback)"
        if (
            f.attr == "sleep"
            and isinstance(f.value, ast.Name)
            and f.value.id == "time"
        ):
            return "time.sleep() (unconditional stall)"
        if f.attr in ("get", "put"):
            # Timeout-less Queue.get blocks forever on an empty queue,
            # and put on a full bounded one — inside a critical section
            # that is a deadlock waiting for its producer/consumer to
            # need the same lock. Receiver must look like a queue
            # (q / _q / *queue / *_q) so dict.get etc. don't
            # false-positive; any positional arg or timeout/block
            # keyword makes get non-blocking-or-bounded.
            recv = f.value
            name = (
                recv.id if isinstance(recv, ast.Name)
                else recv.attr if isinstance(recv, ast.Attribute)
                else None
            )
            if name is None:
                return None
            base = name.lstrip("_").lower()
            queueish = (
                base in ("q", "queue", "inbox")
                or base.endswith("queue") or name.endswith("_q")
            )
            if not queueish:
                return None
            kwargs = {kw.arg for kw in node.keywords}
            if kwargs & {"timeout", "block"}:
                return None
            if f.attr == "get" and node.args:
                return None  # get(False) / get(timeout) forms
            if f.attr == "put" and len(node.args) >= 2:
                return None  # put(item, False) / put(item, True, t)
            return (
                f"{name}.{f.attr}() without a timeout (may block "
                "indefinitely)"
            )
        return None


# -- rule: metrics-naming -----------------------------------------------------

class MetricsNamingRule:
    name = "metrics-naming"
    description = (
        "metric names registered via .counter/.gauge/.histogram must "
        "match ^pixie_[a-z0-9_]+$ and avoid histogram-series suffixes; "
        "bounded-cardinality label keys (tenant) must take values from "
        "their registered-set resolver, never raw client strings"
    )

    _KINDS = frozenset({"counter", "gauge", "histogram"})
    #: Label keys whose value space is an operator-registered set: a
    #: raw client string here makes Prometheus series cardinality
    #: unbounded (services/tenancy.py). The value at a ``.labels()``
    #: call site must visibly come from the resolver — a direct
    #: ``resolve_tenant(...)`` call, a name assigned from one in an
    #: enclosing scope, or ``DEFAULT_TENANT``. Reviewed pass-through
    #: sites (the resolver ran in the caller) live in the counted
    #: baseline, so any NEW unreviewed site fails the --analyze gate.
    _BOUNDED_LABELS = {"tenant": "resolve_tenant"}

    def prepare(self, ctxs, repo_root=None):
        pass

    def check(self, ctx: FileCtx):
        yield from self._check_names(ctx)
        yield from self._check_bounded_labels(ctx)

    def _check_names(self, ctx: FileCtx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (isinstance(f, ast.Attribute) and f.attr in self._KINDS):
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if not (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                continue
            name = arg.value
            qn = ctx.qualname(node)
            if not METRIC_RE.match(name):
                yield Finding(
                    rule=self.name,
                    path=ctx.relpath,
                    line=node.lineno,
                    message=(
                        f"metric name {name!r} violates "
                        "^pixie_[a-z0-9_]+$"
                    ),
                    symbol=qn,
                )
            elif f.attr != "histogram" and name.endswith(
                RESERVED_SUFFIXES
            ):
                yield Finding(
                    rule=self.name,
                    path=ctx.relpath,
                    line=node.lineno,
                    message=(
                        f"{f.attr} name {name!r} ends in a reserved "
                        "Prometheus histogram-series suffix"
                    ),
                    symbol=qn,
                )

    @classmethod
    def _resolver_bindings(cls, scope_node, resolver: str) -> set:
        """Names assigned from ``resolver(...)`` directly in ``scope``
        — nested function/class scopes are NOT searched (they carry
        their own bindings on the visit stack), so a pass-through
        parameter that merely shares a name with some other function's
        resolved variable does not silently pass."""
        names: set = set()
        stack = list(ast.iter_child_nodes(scope_node))
        while stack:
            n = stack.pop()
            if isinstance(
                n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                continue  # scope boundary
            stack.extend(ast.iter_child_nodes(n))
            # Any assignment form that binds a name to resolver(...):
            # plain, annotated (`tenant: str = resolve_tenant(x)`), or
            # walrus (`if (t := resolve_tenant(x)):`).
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                targets, call = n.targets, n.value
            elif (isinstance(n, ast.AnnAssign)
                    and isinstance(n.value, ast.Call)):
                targets, call = [n.target], n.value
            elif (isinstance(n, ast.NamedExpr)
                    and isinstance(n.value, ast.Call)):
                targets, call = [n.target], n.value
            else:
                continue
            f = call.func
            fname = (
                f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None
            )
            if fname != resolver:
                continue
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        return names

    def _value_is_resolved(self, value, resolver: str, bound: set) -> bool:
        if isinstance(value, ast.Call):
            f = value.func
            fname = (
                f.id if isinstance(f, ast.Name)
                else f.attr if isinstance(f, ast.Attribute) else None
            )
            return fname == resolver
        if isinstance(value, ast.Name):
            return value.id == "DEFAULT_TENANT" or value.id in bound
        if isinstance(value, ast.Attribute):
            return value.attr == "DEFAULT_TENANT"
        return False

    def _check_bounded_labels(self, ctx: FileCtx):
        findings = []

        # Resolver bindings are collected per scope and carried on a
        # stack: module-level bindings apply everywhere, a function's
        # bindings apply inside it (and its nested functions).
        def visit_scoped(node, stack):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)
            ):
                resolved = set()
                for r in {v for v in self._BOUNDED_LABELS.values()}:
                    resolved |= self._resolver_bindings(node, r)
                stack = stack + [resolved]
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "labels"):
                bound = set().union(*stack) if stack else set()
                for kw in node.keywords:
                    resolver = self._BOUNDED_LABELS.get(kw.arg or "")
                    if resolver is None:
                        continue
                    if not self._value_is_resolved(
                        kw.value, resolver, bound
                    ):
                        findings.append(Finding(
                            rule=self.name,
                            path=ctx.relpath,
                            line=node.lineno,
                            message=(
                                f"label {kw.arg}=... must be derived "
                                f"from {resolver}() (bounded metric-"
                                "label cardinality: tenants come from "
                                "the registered set, not raw client "
                                "strings) — resolve in this scope, or "
                                "baseline the reviewed pass-through "
                                "site"
                            ),
                            symbol=ctx.qualname(node),
                        ))
            for child in ast.iter_child_nodes(node):
                visit_scoped(child, stack)

        visit_scoped(ctx.tree, [])
        yield from findings


ALL_RULES = (
    HostSyncHotPathRule,
    ThreadSharedStateRule,
    LockOrderRule,
    RequestFromHandlerRule,
    BlockingCallUnderLockRule,
    MetricsNamingRule,
)


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(__file__), "baseline.json")


def load_baseline(path: str | None = None) -> dict:
    """key -> allowed occurrence count. Counts matter: a key whose
    occurrences GROW has gained a new violation (same rule, same
    function, same message) and must fail, not hide behind the old
    grandfathered finding."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        try:
            data = json.load(f)
        except json.JSONDecodeError:
            return {}  # empty/garbage baseline = no baseline
    out: dict = {}
    for e in data.get("findings", []):
        key = (e["rule"], e["path"], e["symbol"], e["message"])
        out[key] = out.get(key, 0) + int(e.get("count", 1))
    return out


def save_baseline(findings, path: str | None = None) -> None:
    path = path or default_baseline_path()
    counts: dict = {}
    for f in findings:
        counts[f.key()] = counts.get(f.key(), 0) + 1
    with open(path, "w") as fh:
        json.dump(
            {
                "version": 1,
                "findings": [
                    {
                        "rule": r, "path": p, "symbol": s, "message": m,
                        "count": c,
                    }
                    for (r, p, s, m), c in sorted(counts.items())
                ],
            },
            fh,
            indent=2,
        )
        fh.write("\n")


@dataclass
class LintReport:
    findings: list  # non-suppressed, non-baselined
    baselined: list
    suppressed: int
    files: int

    @property
    def ok(self) -> bool:
        return not self.findings


def _iter_py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = [
                d for d in dirs
                if d != "__pycache__" and not d.startswith(".")
            ]
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


def run_lint(paths, rules=None, baseline_path=None,
             repo_root=None) -> LintReport:
    """Lint ``paths`` (files or directories) with ``rules`` (rule name
    list or None = all), applying inline suppressions and the baseline.
    """
    repo_root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    rule_objs = []
    for cls in ALL_RULES:
        r = cls()
        if rules is None or r.name in rules:
            rule_objs.append(r)
    ctxs = []
    for path in _iter_py_files(paths):
        ap = os.path.abspath(path)
        rel = os.path.relpath(ap, repo_root)
        try:
            with open(ap) as f:
                src = f.read()
            ctxs.append(FileCtx(ap, rel, src))
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue  # not lintable python (templates, fixtures)
    for r in rule_objs:
        r.prepare(ctxs, repo_root)
    baseline = load_baseline(baseline_path)
    budget = dict(baseline)  # remaining allowed occurrences per key
    findings, baselined, suppressed = [], [], 0
    for ctx in ctxs:
        for r in rule_objs:
            for f in r.check(ctx):
                if ctx.suppressed(f.rule, f.line):
                    suppressed += 1
                elif budget.get(f.key(), 0) > 0:
                    budget[f.key()] -= 1
                    baselined.append(f)
                else:
                    findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintReport(
        findings=findings, baselined=baselined, suppressed=suppressed,
        files=len(ctxs),
    )


# -- command line -------------------------------------------------------------

#: The repo root: the directory that holds ``pixie_tpu_torch/``.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_PATHS = [os.path.join(REPO, "pixie_tpu_torch")]


def main(argv=None) -> int:
    """The gate: lint ``paths`` (``pixie_tpu_torch/`` by default) with the
    options of ``tools/pxlint.py``; exit 1 on any finding that is neither
    suppressed nor baselined, 2 on a usage error."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m pixie_tpu_torch.analysis.lint",
        description="Run the pxlint rules over the port's tree.")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS)
    ap.add_argument("--rules", help="comma-separated rule names (default all)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline path (default {default_baseline_path()})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline with the current findings")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for cls in ALL_RULES:
            r = cls()
            print(f"{r.name}: {r.description}")
        return 0

    if args.update_baseline and (
        args.rules or args.paths is not DEFAULT_PATHS
    ):
        # A filtered run sees only a subset of findings; rewriting the
        # baseline from it would drop every entry of the rules or paths
        # that did not run.
        print("pxlint: --update-baseline requires a full run "
              "(no --rules, no path arguments)", file=sys.stderr)
        return 2

    rules = (
        {r.strip() for r in args.rules.split(",") if r.strip()}
        if args.rules else None
    )
    if rules is not None:
        known = {cls().name for cls in ALL_RULES}
        bad = rules - known
        if bad:
            print(f"pxlint: unknown rule(s) {sorted(bad)}; "
                  f"known: {sorted(known)}", file=sys.stderr)
            return 2

    report = run_lint(args.paths, rules=rules, baseline_path=args.baseline,
                      repo_root=REPO)

    if args.update_baseline:
        save_baseline(report.findings + report.baselined,
                      args.baseline or default_baseline_path())
        print(f"pxlint: baseline updated with "
              f"{len(report.findings) + len(report.baselined)} finding(s)")
        return 0

    if args.as_json:
        print(json.dumps({
            "findings": [f.__dict__ for f in report.findings],
            "baselined": len(report.baselined),
            "suppressed": report.suppressed,
            "files": report.files,
        }, indent=2))
    else:
        for f in report.findings:
            print(f.render())
        print(f"pxlint: {len(report.findings)} finding(s), "
              f"{len(report.baselined)} baselined, "
              f"{report.suppressed} suppressed, {report.files} files",
              file=sys.stderr)
    return 1 if report.findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
