"""The ELF and DWARF readers, ``native_probe_plan`` and the bloom filter
of the port against the JAX package.

``utils/elf.py``, ``utils/dwarf.py`` and ``utils/bloomfilter.py`` are
copies of the JAX package's host readers. Each case of
``tests/test_dwarf.py`` and of ``tests/test_utils.py``'s
``TestBloomFilter`` and ``TestELFReader`` has a counterpart here: both
packages read the same bytes (a fixture compiled with ``g++ -g``, the
port's native ring library, a file that is not ELF), their answers are
equal field for field, and the JAX case's assertions hold for the
port's.
"""

import dataclasses
import subprocess

import numpy as np
import pytest

from pixie_tpu.ingest.dynamic import TraceError as JaxTraceError
from pixie_tpu.ingest.dynamic import native_probe_plan as jax_native_probe_plan
from pixie_tpu.utils.bloomfilter import BloomFilter as JaxBloomFilter
from pixie_tpu.utils.dwarf import DwarfError as JaxDwarfError
from pixie_tpu.utils.dwarf import DwarfReader as JaxDwarfReader
from pixie_tpu.utils.elf import ELFError as JaxELFError
from pixie_tpu.utils.elf import ELFReader as JaxELFReader
from pixie_tpu_torch import native
from pixie_tpu_torch.ingest.dynamic import TraceError, native_probe_plan
from pixie_tpu_torch.utils import BloomFilter
from pixie_tpu_torch.utils.dwarf import DwarfError, DwarfReader
from pixie_tpu_torch.utils.elf import ELFError, ELFReader

from test_dwarf import FIXTURE_SRC


@pytest.fixture(scope="module")
def fixture_bin(tmp_path_factory):
    d = tmp_path_factory.mktemp("dwarf")
    src = d / "fix.c"
    src.write_text(FIXTURE_SRC)
    out = d / "fix"
    try:
        subprocess.run(
            ["g++", "-g", "-O0", "-o", str(out), str(src)],
            check=True, capture_output=True,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        pytest.skip("g++ unavailable")
    return str(out)


@pytest.fixture(scope="module")
def readers(fixture_bin):
    return JaxDwarfReader(fixture_bin), DwarfReader(fixture_bin)


def _fields(x):
    """Dataclasses (and tuples and dicts of them) as plain values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _fields(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_fields(v) for v in x]
    if isinstance(x, dict):
        return {k: _fields(v) for k, v in x.items()}
    return x


# -- tests/test_dwarf.py ----------------------------------------------------------
def test_whole_index_equal(readers):
    jax, port = readers
    assert _fields(port.functions) == _fields(jax.functions)
    assert _fields(port.structs) == _fields(jax.structs)
    assert "process_request" in port.functions and "conn_info" in port.structs


def test_function_arg_info(readers):
    jax, port = readers
    args = port.get_function_arg_info("process_request")
    assert _fields(args) == _fields(jax.get_function_arg_info("process_request"))
    assert [a.name for a in args] == ["conn", "status", "latency"]
    assert args[0].type_name == "struct conn_info*"
    assert args[0].byte_size == 8
    assert args[1].type_name == "int" and args[1].byte_size == 4
    assert args[2].type_name == "duration_ns"
    assert args[2].byte_size == 8
    assert all(a.frame_offset is not None for a in args)


def test_float_args(readers):
    jax, port = readers
    a, b = port.get_function_arg_info("score")
    assert _fields((a, b)) == _fields(jax.get_function_arg_info("score"))
    assert (a.type_name, a.byte_size) == ("double", 8)
    assert (b.type_name, b.byte_size) == ("float", 4)


def test_struct_layout(readers):
    jax, port = readers
    spec = port.get_struct_spec("conn_info")
    assert _fields(spec) == _fields(jax.get_struct_spec("conn_info"))
    by = {m.name: m for m in spec}
    assert by["id"].offset == 0 and by["id"].byte_size == 8
    assert by["port"].offset == 8 and by["port"].byte_size == 4
    assert by["proto"].offset == 12 and by["proto"].byte_size == 1
    assert by["rtt"].offset == 16 and by["rtt"].type_name == "double"
    m = port.get_struct_member_info("conn_info", "rtt")
    assert _fields(m) == _fields(jax.get_struct_member_info("conn_info", "rtt"))
    assert m.offset == 16


def test_low_pc_matches_elf_symbol(readers, fixture_bin):
    jax, port = readers
    e, je = ELFReader(fixture_bin), JaxELFReader(fixture_bin)
    addr = e.symbol_addr("process_request")
    assert addr == je.symbol_addr("process_request")
    assert port.functions["process_request"].low_pc == addr
    assert jax.functions["process_request"].low_pc == addr


@pytest.mark.parametrize("lookup", [
    ("get_function_arg_info", ("nope",)),
    ("get_struct_member_info", ("conn_info", "nope")),
    ("get_struct_spec", ("nope",)),
], ids=lambda c: c[0])
def test_missing_lookups_raise(readers, lookup):
    name, args = lookup
    for r in readers:
        with pytest.raises(KeyError):
            getattr(r, name)(*args)


def test_non_debug_binary_raises(tmp_path):
    src = tmp_path / "nodbg.c"
    src.write_text("int main(){return 0;}\n")
    out = tmp_path / "nodbg"
    try:
        subprocess.run(["g++", "-O1", "-o", str(out), str(src)],
                       check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError):
        pytest.skip("g++ unavailable")
    msgs = []
    for reader, err in ((JaxDwarfReader, JaxDwarfError), (DwarfReader, DwarfError)):
        with pytest.raises(err, match="no DWARF") as ei:
            reader(str(out))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_plan_resolves_args(fixture_bin):
    plan = native_probe_plan(fixture_bin, "process_request")
    assert plan == jax_native_probe_plan(fixture_bin, "process_request")
    assert plan["address"] > 0
    assert set(plan["args"]) == {"conn", "status", "latency"}
    assert plan["args"]["status"]["type"] == "int"
    assert plan["args"]["latency"]["size"] == 8
    assert plan["args"]["conn"]["frame_offset"] is not None


@pytest.mark.parametrize("target", ["function", "file", "not_elf"])
def test_unknown_function_raises(fixture_bin, tmp_path, target):
    """An unknown function, a missing file and a file that is not ELF:
    TraceError in both packages, with the same message."""
    path, fn = fixture_bin, "does_not_exist"
    if target == "file":
        path = str(tmp_path / "missing")
    elif target == "not_elf":
        path = str(tmp_path / "x")
        (tmp_path / "x").write_bytes(b"not an elf at all")
        fn = "process_request"
    msgs = []
    for plan, err in ((jax_native_probe_plan, JaxTraceError),
                      (native_probe_plan, TraceError)):
        with pytest.raises(err) as ei:
            plan(path, fn)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    if target == "function":
        assert "no DWARF subprogram" in msgs[1]


# -- tests/test_utils.py: TestBloomFilter ------------------------------------------
@pytest.mark.parametrize("max_entries,error_rate", [(1000, 0.01), (100, 0.01),
                                                    (5000, 0.001)])
def test_bloom_membership(max_entries, error_rate):
    bf, jbf = BloomFilter(max_entries, error_rate), JaxBloomFilter(max_entries, error_rate)
    items = [f"pod-{i}" for i in range(max_entries // 2)]
    for it in items:
        bf.insert(it)
        jbf.insert(it)
    assert bf.to_bytes() == jbf.to_bytes()
    assert all(bf.contains(it) for it in items)
    others = [f"other-{i}" for i in range(2000)]
    got = [bf.contains(o) for o in others]
    assert got == [jbf.contains(o) for o in others]
    assert sum(got) < 2000 * 5 * error_rate


def test_bloom_serialization_round_trip():
    """A filter's bytes read back in the other package, both ways."""
    for make, read in ((BloomFilter, JaxBloomFilter.from_bytes),
                       (JaxBloomFilter, BloomFilter.from_bytes)):
        bf = make(100)
        bf.insert("svc/default/frontend")
        bf2 = read(bf.to_bytes())
        assert bf2.contains("svc/default/frontend")
        assert not bf2.contains("svc/default/backend")
        assert np.array_equal(bf2.bits, bf.bits)
        assert bf2.to_bytes() == bf.to_bytes()


def test_bloom_rejects_bad_arguments():
    for cls in (BloomFilter, JaxBloomFilter):
        with pytest.raises(ValueError):
            cls(0)
        with pytest.raises(ValueError):
            cls(10, 1.5)


# -- tests/test_utils.py: TestELFReader ---------------------------------------------
def test_elf_symbols_and_addr_lookup():
    """obj_tools parity: both readers over the port's native ring."""
    so = str(native.library_path("table_ring"))
    native.load("table_ring")
    r, jr = ELFReader(so), JaxELFReader(so)
    assert r.symbols, "no FUNC symbols parsed"
    assert _fields(r.symbols) == _fields(jr.symbols)
    names = {s.name for s in r.symbols}
    assert any("ring" in n or "table" in n for n in names), sorted(names)[:10]
    for s in r.symbols:
        probe = s.addr + max(s.size // 2, 0)
        assert r.addr_to_symbol(probe) == jr.addr_to_symbol(probe)
        assert r.symbol_addr(s.name) == jr.symbol_addr(s.name)
    s = r.symbols[len(r.symbols) // 2]
    assert r.addr_to_symbol(s.addr + max(s.size // 2, 0)) == s.name
    assert r.addr_to_symbol(0) is None and jr.addr_to_symbol(0) is None


def test_elf_rejects_non_elf(tmp_path):
    p = tmp_path / "x"
    p.write_bytes(b"not an elf")
    msgs = []
    for reader, err in ((JaxELFReader, JaxELFError), (ELFReader, ELFError)):
        with pytest.raises(err) as ei:
            reader(str(p))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
