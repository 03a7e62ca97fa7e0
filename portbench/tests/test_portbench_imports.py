"""No run loads JAX or the JAX package: whole top-level names compared."""

import subprocess
import sys

from portbench import run

from conftest import CHECKOUT, ROWS, WINDOW


def test_whole_top_level_names_are_compared(monkeypatch):
    before = run.forbidden_modules()
    for name in ("pixie_tpu_torch", "pixie_tpu_torch.exec", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "pixie_tpu.exec", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(run.forbidden_modules()) == set(before) | {"pixie_tpu", "jaxlib"}


def test_a_run_loads_no_jax_module():
    code = (
        "from portbench import run\n"
        "c = run.find_cell('pem_default.http_stats')\n"
        f"r = run.run_cell(c, 5, 1.0, True, device='cpu', rows={ROWS}, window_rows={WINDOW})\n"
        "assert r['correct'], r\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
