"""The datastore and UPID cases of ``tests/test_utils.py`` on both
packages (the bloom filter and ELF cases are in
``tests/test_torch_dwarf.py``).

Each case runs the JAX case's assertions on the JAX package's
``utils`` and on the port's, and the two packages' observations (values
read back, prefix scans, UPID values, strings and planes) must be equal.
The port's ``HostBatch.to_device`` takes its capacity and the device
(the CPU here) explicitly.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import pixie_tpu.utils as jax_utils
import pixie_tpu.utils.upid as jax_upid
import pixie_tpu_torch.utils as port_utils
import pixie_tpu_torch.utils.upid as port_upid
from pixie_tpu.types.batch import HostBatch as JaxHostBatch
from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.types.relation import Relation as JaxRelation
from pixie_tpu_torch.types import bucket_capacity
from pixie_tpu_torch.types.batch import HostBatch
from pixie_tpu_torch.types.dtypes import DataType
from pixie_tpu_torch.types.relation import Relation

PKGS = {
    "jax": types.SimpleNamespace(
        utils=jax_utils, upid=jax_upid, HostBatch=JaxHostBatch,
        DataType=JaxDataType, Relation=JaxRelation,
        to_device=lambda hb: hb.to_device()),
    "port": types.SimpleNamespace(
        utils=port_utils, upid=port_upid, HostBatch=HostBatch,
        DataType=DataType, Relation=Relation,
        to_device=lambda hb: hb.to_device(bucket_capacity(hb.length),
                                          torch.device("cpu"))),
}


def _both(case):
    """Run ``case(name, p)`` on each package; the observations must
    agree."""
    got = {name: case(name, p) for name, p in PKGS.items()}
    assert got["port"] == got["jax"], got
    return got["port"]


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
class TestDatastore:
    @staticmethod
    def _mk(p, backend, path):
        if backend == "memory":
            return p.utils.MemoryDatastore()
        return p.utils.SqliteDatastore(str(path))

    def test_crud(self, backend, tmp_path):
        def case(name, p):
            ds = self._mk(p, backend, tmp_path / f"{name}.db")
            assert ds.get("a") is None
            ds.set("a", b"1")
            ds.set("a", b"2")  # upsert
            got = ds.get("a")
            assert got == b"2"
            ds.delete("a")
            assert ds.get("a") is None
            return got

        _both(case)

    def test_prefix_scan(self, backend, tmp_path):
        def case(name, p):
            ds = self._mk(p, backend, tmp_path / f"{name}.db")
            for k in ("agent/1", "agent/2", "tracepoint/1"):
                ds.set(k, k.encode())
            got = ds.get_with_prefix("agent/")
            assert [k for k, _ in got] == ["agent/1", "agent/2"]
            ds.delete_with_prefix("agent/")
            assert ds.get_with_prefix("agent/") == []
            assert ds.get("tracepoint/1") == b"tracepoint/1"
            return [(k, bytes(v)) for k, v in got]

        _both(case)


def test_sqlite_persists(tmp_path):
    def case(name, p):
        path = str(tmp_path / f"{name}.db")
        ds = p.utils.SqliteDatastore(path)
        ds.set("cron/1", b"script")
        ds.close()
        ds2 = p.utils.SqliteDatastore(path)
        got = ds2.get("cron/1")
        assert got == b"script"
        ds2.close()
        return got

    _both(case)


class TestUPID:
    def test_pack_unpack(self):
        def case(name, p):
            UPID = p.utils.UPID
            u = UPID(asid=7, pid=1234, start_ts=1_700_000_000_000_000_000)
            v = u.value()
            assert UPID.from_value(v) == u
            assert UPID.parse(str(u)) == u
            return v, str(u)

        _both(case)

    def test_planes_round_trip(self):
        def case(name, p):
            UPID = p.utils.UPID
            ups = [UPID(1, 2, 3), UPID(0xFFFFFFFF, 0xFFFFFFFF, 2**64 - 1)]
            hi, lo = p.upid.pack_planes(ups)
            assert hi.dtype == np.uint64
            assert p.upid.unpack_planes(hi, lo) == ups
            return hi.tolist(), lo.tolist()

        _both(case)

    def test_device_column_round_trip(self):
        def case(name, p):
            UPID = p.utils.UPID
            ups = [UPID(5, 99, 123456789), UPID(6, 100, 987654321)]
            hi, lo = p.upid.pack_planes(ups)
            hb = p.HostBatch.from_pydict(
                {"upid": np.stack([hi, lo], axis=1)},
                relation=p.Relation([("upid", p.DataType.UINT128)]),
            )
            back = p.to_device(hb).to_host().to_pydict()["upid"]
            assert p.upid.unpack_planes(back[:, 0], back[:, 1]) == ups
            return back.tolist()

        _both(case)
