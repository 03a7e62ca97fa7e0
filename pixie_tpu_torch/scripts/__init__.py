"""The shipped PxL scripts this slice of the port runs (copies of the
JAX package's ``scripts/px/<name>/<name>.pxl``)."""

from __future__ import annotations

from pathlib import Path

_ROOT = Path(__file__).resolve().parent / "px"


def load_script(name: str) -> str:
    """PxL source of ``px/<name>`` (or bare ``<name>``)."""
    short = name.split("/", 1)[1] if "/" in name else name
    path = _ROOT / f"{short}.pxl"
    if not path.is_file():
        raise KeyError(f"no script named {name!r} in this slice of the port")
    return path.read_text()
