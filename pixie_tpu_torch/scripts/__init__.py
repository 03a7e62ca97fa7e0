"""Shipped PxL script library: a copy of the JAX package's
``scripts/px/`` (81 directories, each ``manifest.yaml`` + ``<name>.pxl``
+ optional ``vis.json``) with its loader.

Reference parity: ``src/pxl_scripts/px/``. The manifests use a small
YAML subset (``key: scalar``, ``key: [a, "b"]`` flow lists, ``key: >``
folded blocks, ``#`` comments), which ``_parse_manifest`` reads without a
YAML library, so the port does not depend on one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

_SCRIPT_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "px")


@dataclass
class ScriptDef:
    """One shipped script: PxL source + manifest metadata."""

    name: str  # e.g. "px/http_stats"
    path: str
    pxl: str
    manifest: dict = field(default_factory=dict)
    vis: str | None = None  # vis.json contents when present

    @property
    def tables(self) -> list[str]:
        return list(self.manifest.get("tables", []))


def _scalar(s: str):
    s = s.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    if s in ("true", "false"):
        return s == "true"
    try:
        return int(s)
    except ValueError:
        return s


def _parse_manifest(text: str) -> dict:
    """The manifests' YAML subset: top-level ``key: value`` lines, where
    a value is a scalar, a ``[...]`` flow list of scalars, or ``>`` and
    an indented folded block (lines joined by spaces, one trailing
    newline)."""
    out: dict = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        key, _, rest = line.partition(":")
        rest = rest.strip()
        if rest == ">":
            block = []
            while i < len(lines) and (
                not lines[i].strip() or lines[i].startswith(" ")
            ):
                block.append(lines[i].strip())
                i += 1
            out[key.strip()] = " ".join(b for b in block if b) + "\n"
        elif rest.startswith("["):
            body = rest[1:rest.rindex("]")]
            out[key.strip()] = [_scalar(v) for v in body.split(",") if v.strip()]
        else:
            out[key.strip()] = _scalar(rest.split(" #", 1)[0])
    return out


def list_scripts() -> list[str]:
    """Names of every shipped script (sorted)."""
    if not os.path.isdir(_SCRIPT_ROOT):
        return []
    return sorted(
        f"px/{d}"
        for d in os.listdir(_SCRIPT_ROOT)
        if os.path.isdir(os.path.join(_SCRIPT_ROOT, d))
        and any(
            f.endswith(".pxl")
            for f in os.listdir(os.path.join(_SCRIPT_ROOT, d))
        )
    )


def load_script(name: str) -> ScriptDef:
    """Load ``px/<short>`` (or bare ``<short>``) from the library."""
    short = name.split("/", 1)[1] if "/" in name else name
    d = os.path.join(_SCRIPT_ROOT, short)
    if not os.path.isdir(d):
        raise KeyError(f"no shipped script named {name!r}")
    pxl_files = [f for f in os.listdir(d) if f.endswith(".pxl")]
    if not pxl_files:
        raise KeyError(f"script dir {d} has no .pxl file")
    with open(os.path.join(d, sorted(pxl_files)[0])) as f:
        pxl = f.read()
    manifest = {}
    mpath = os.path.join(d, "manifest.yaml")
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = _parse_manifest(f.read())
    vis = None
    vpath = os.path.join(d, "vis.json")
    if os.path.exists(vpath):
        with open(vpath) as f:
            vis = f.read()
    return ScriptDef(
        name=f"px/{short}", path=d, pxl=pxl, manifest=manifest, vis=vis
    )


def load_all() -> list[ScriptDef]:
    return [load_script(n) for n in list_scripts()]
