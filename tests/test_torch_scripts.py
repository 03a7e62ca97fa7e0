"""The shipped script library on the port against the JAX package.

Every script of ``pixie_tpu_torch/scripts`` is a copy of the JAX
package's (source, manifest and vis spec), compiles to the JAX
package's plan against the canonical schemas, and executes on the
port's CPU engine over the rows of ``tests/test_scripts.py``'s
``_seed_all_tables`` to the JAX engine's answer over the same rows.

The comparison is ``chip_smoke.check_library_output``, the one the card's
library phase holds the card to the CPU engine with. Tolerances: keys,
strings, integers and times are exact, so are the ``count_distinct``
estimates (equal dictionary ids hash to equal HLL registers); FLOAT64
values are rtol 1e-5 (f32 window sums in another order); values derived
from a t-digest quantile (traced through the plan from a
``quantiles``/``_quantile_*`` aggregate) are rtol 0.05, the JAX
package's own Pallas-vs-XLA tolerance (tests/test_pallas.py). Row
scripts (no aggregate, join or union) compare in row order; the others
compare as row sets, sorted by their exactly-compared columns.
``px/agent_status`` reads the agent tracker over the service bus, which
the port does not have yet.
"""

import pytest
import torch

from pixie_tpu.config import set_flag as jax_set_flag
from pixie_tpu.exec import Engine as JaxEngine
from pixie_tpu.ingest.schemas import CANONICAL_SCHEMAS as JAX_SCHEMAS
from pixie_tpu.ingest.schemas import init_schemas as jax_init_schemas
from pixie_tpu.planner import CompilerState as JaxCompilerState
from pixie_tpu.planner import compile_pxl as jax_compile_pxl
from pixie_tpu.scripts import list_scripts as jax_list_scripts
from pixie_tpu.scripts import load_script as jax_load_script
from pixie_tpu.udf.registry import default_registry as jax_registry
from chip_smoke import _quantile_columns, check_library_output
from pixie_tpu_torch import Engine
from pixie_tpu_torch.ingest.schemas import CANONICAL_SCHEMAS, init_schemas
from pixie_tpu_torch.planner import CompilerState, compile_pxl
from pixie_tpu_torch.scripts import list_scripts, load_script
from pixie_tpu_torch.udf.registry import default_registry

from test_scripts import _seed_all_tables
from test_torch_planner import _plan_shape

WINDOW = 1 << 11
AGENT_STATUS = "px/agent_status"
NEEDS_SERVICES = "GetAgentStatus needs the service bus (ROADMAP item 18)"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    jax_eng = JaxEngine(window_rows=WINDOW)
    jax_init_schemas(jax_eng)
    _seed_all_tables(jax_eng)
    eng = Engine(window_rows=WINDOW, device="cpu")
    init_schemas(eng)
    _seed_all_tables(eng)
    return jax_eng, eng


def _skip_agent_status(name):
    if name == AGENT_STATUS:
        pytest.skip(NEEDS_SERVICES)


def test_library_is_the_jax_packages():
    assert list_scripts() == jax_list_scripts()
    assert len(list_scripts()) == 81


@pytest.mark.parametrize("name", list_scripts())
def test_script_copy_matches_jax_package(name):
    got, ref = load_script(name), jax_load_script(name)
    assert (got.pxl, got.manifest, got.vis, got.tables) == (
        ref.pxl, ref.manifest, ref.vis, ref.tables)


def test_canonical_schemas_match_jax_package():
    assert list(CANONICAL_SCHEMAS) == list(JAX_SCHEMAS)
    for name, rel in CANONICAL_SCHEMAS.items():
        assert [(c, t.name) for c, t in rel.items()] == [
            (c, t.name) for c, t in JAX_SCHEMAS[name].items()], name


@pytest.mark.parametrize("name", list_scripts())
def test_compiles_like_jax(name):
    _skip_agent_status(name)
    pxl = load_script(name).pxl
    got = compile_pxl(pxl, CompilerState(
        schemas=dict(CANONICAL_SCHEMAS), registry=default_registry(),
        now_ns=10**18, max_output_rows=10_000,
    ))
    ref = jax_compile_pxl(pxl, JaxCompilerState(
        schemas=dict(JAX_SCHEMAS), registry=jax_registry(),
        now_ns=10**18, max_output_rows=10_000,
    ))
    assert _plan_shape(got.plan) == _plan_shape(ref.plan)
    assert got.outputs == ref.outputs


@pytest.mark.parametrize("name", list_scripts())
def test_executes_like_jax(name, engines):
    _skip_agent_status(name)
    jax_eng, eng = engines
    pxl = load_script(name).pxl
    compiled = compile_pxl(pxl, CompilerState(
        schemas={n: t.relation for n, t in eng.tables.items()},
        registry=eng.registry, now_ns=0, max_output_rows=10_000,
    ))
    loose, ordered = _quantile_columns(compiled.plan)
    jax_set_flag("cpu_fold_threads", 1)
    try:
        ref = jax_eng.execute_query(pxl, max_output_rows=10_000)
    finally:
        jax_set_flag("cpu_fold_threads", 0)
    got = eng.execute_query(pxl, max_output_rows=10_000)
    assert sorted(got) == sorted(ref)
    assert sum(hb.length for hb in got.values()) > 0, name
    for out in got:
        check_library_output(f"{name}:{out}", got[out], ref[out], loose[out],
                             ordered)
