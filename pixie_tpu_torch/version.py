"""Build/version metadata.

Reference parity: ``src/shared/version`` (version.h
``VersionInfo``: semver + git commit + build time, surfaced on statusz
and the artifacts API). Populated from the environment at build/deploy
time; falls back to the dev defaults.
"""

from __future__ import annotations

import os
import time

VERSION = os.environ.get("PIXIE_TPU_VERSION", "0.3.0-dev")
BUILD_TIME_S = int(os.environ.get("PIXIE_TPU_BUILD_TIME", "0")) or None
_PROCESS_START_S = time.time()


def _git_commit() -> str:
    """Dev fallback, lazy + cached: ask git for the SOURCE CHECKOUT's
    HEAD (container builds stamp PIXIE_TPU_GIT_COMMIT instead — the
    linkstamp analog). Only fires when the package parent directory is
    itself a git checkout — a wheel installed inside some unrelated
    repo must report "unknown", not that repo's HEAD."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if not os.path.exists(os.path.join(root, ".git")):
        return "unknown"
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=5,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "unknown"


_GIT_COMMIT_CACHE: str | None = os.environ.get("PIXIE_TPU_GIT_COMMIT") or None


def git_commit() -> str:
    global _GIT_COMMIT_CACHE
    if _GIT_COMMIT_CACHE is None:
        _GIT_COMMIT_CACHE = _git_commit()
    return _GIT_COMMIT_CACHE


def version_info() -> dict:
    """The VersionInfo struct: shipped on statusz and the CLI."""
    return {
        "version": VERSION,
        "git_commit": git_commit(),
        "build_time_s": BUILD_TIME_S,
        "uptime_s": round(time.time() - _PROCESS_START_S, 1),
    }
