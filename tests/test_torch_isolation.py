"""The port stands alone: no file of ``pixie_tpu_torch/`` (nor
``chip_smoke.py``) imports JAX or the JAX package, a CPU query leaves
neither in ``sys.modules``, and nothing falls back to the CPU or to a
plain version on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "pixie_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "pixie_tpu")


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES]
)
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_cpu_query_loads_neither_jax_nor_the_jax_package():
    code = """
import sys
import numpy as np
from pixie_tpu_torch import Engine
eng = Engine(window_rows=1024, device="cpu")
eng.append_data("t", {"time_": np.arange(3000), "k": ["a", "b", "c"] * 1000,
                      "v": np.arange(3000)})
out = eng.execute_query(
    "import px\\ndf = px.DataFrame(table='t')\\n"
    "px.display(df.groupby('k').agg(n=('v', px.count), s=('v', px.sum)))"
)["output"].to_pydict()
assert sorted(out["n"].tolist()) == [1000, 1000, 1000], out
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "pixie_tpu")]
assert not bad, bad
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_engine_without_a_card_raises(monkeypatch):
    from pixie_tpu_torch import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()
    assert Engine(device="cpu").device.type == "cpu"


def test_failed_kernel_build_raises(monkeypatch, tmp_path):
    from pixie_tpu_torch.ops import cuda_lib

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(cuda_lib.KernelBuildError, match="nvcc not found"):
        cuda_lib.build()
