"""Wire format: versioned self-describing binary encoding for the
control and data planes.

Reference parity: Carnot ships RowBatches and exec errors as protobuf
over gRPC (``src/carnot/carnotpb/carnot.proto:96-99``
``TransferResultChunkRequest``) and control messages as protobuf NATS
envelopes (``src/vizier/messages/messagespb``). This codec plays both
roles for this runtime: every message the in-process bus carries — plan
dispatch, bridge payloads (partial-agg state pytrees, row batches),
results, tracepoint deployments — round-trips through ``encode`` /
``decode`` so agents can live in separate processes (see ``netbus.py``).

Design: tag-prefixed recursive encoding over an explicit TYPE TABLE —
no pickle, no arbitrary code execution on decode; unknown tags/types are
hard errors. The first byte is the format version.

A port of the JAX package's ``services/wire.py``: the same tags, the same
type table in the same order (a type's tag is its index) and the same
``WIRE_VERSION``, so the two packages' bytes for a plan, a batch or a
control message are equal. Only host values cross the wire: a
``torch.Tensor`` anywhere in a message raises ``WireError`` (state leaves
leave the card as numpy through ``exec/bridge.py`` ``state_to_host``).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

WIRE_VERSION = 4  # v4: AggStatePayload.dense_strides (v3: .dense_offsets)

_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_U16 = struct.Struct("<H")


class WireError(Exception):
    pass


def _registered_types():
    """The closed set of structured types allowed on the wire."""
    from ..exec import otel as _otel
    from ..exec import plan as _plan
    from ..exec.bridge import AggStatePayload, RowsPayload
    from ..trace import spec as _trace
    from ..types.batch import HostBatch
    from ..types.relation import Relation
    from ..types.strings import StringDictionary

    types = [
        Relation,
        StringDictionary,
        HostBatch,
        AggStatePayload,
        RowsPayload,
        _plan.Plan,
        _plan.PlanNode,
        _plan.MemorySourceOp,
        _plan.MapOp,
        _plan.FilterOp,
        _plan.AggOp,
        _plan.JoinOp,
        _plan.LimitOp,
        _plan.UnionOp,
        _plan.UDTFSourceOp,
        _plan.EmptySourceOp,
        _plan.BridgeSinkOp,
        _plan.BridgeSourceOp,
        _plan.OTelExportSinkOp,
        _plan.ResultSinkOp,
        _plan.TableSinkOp,
        _plan.ColumnRef,
        _plan.Literal,
        _plan.FuncCall,
        _plan.AggExpr,
        _otel.OTelEndpointConfig,
        _otel.OTelMetricGauge,
        _otel.OTelMetricSummary,
        _otel.OTelSpan,
        _otel.OTelDataSpec,
        _trace.TraceExpr,
        _trace.ProbeDef,
        _trace.TracepointDeployment,
        _trace.TracepointDelete,
    ]
    return types


_TYPES: list | None = None
_TYPE_IDS: dict | None = None


def _tables():
    global _TYPES, _TYPE_IDS
    if _TYPES is None:
        _TYPES = _registered_types()
        _TYPE_IDS = {t: i for i, t in enumerate(_TYPES)}
    return _TYPES, _TYPE_IDS


def _obj_fields(obj) -> dict:
    """Structured object -> plain field dict (encoder side)."""
    from ..exec.plan import Plan
    from ..types.batch import HostBatch
    from ..types.relation import Relation
    from ..types.strings import StringDictionary

    if isinstance(obj, Relation):
        return {"items": [(n, t.value) for n, t in obj.items()]}
    if isinstance(obj, StringDictionary):
        return {"strings": list(obj.strings)}
    if isinstance(obj, HostBatch):
        for n, ps in obj.cols.items():
            if any(isinstance(p, torch.Tensor) for p in ps):
                raise WireError(
                    f"column {n!r} holds a torch.Tensor; only host (numpy) "
                    "planes cross the wire"
                )
        return {
            "relation": obj.relation,
            "cols": {n: tuple(np.asarray(p) for p in ps)
                     for n, ps in obj.cols.items()},
            "length": obj.length,
            "dicts": dict(obj.dicts),
            "eow": obj.eow,
            "eos": obj.eos,
        }
    if isinstance(obj, Plan):
        return {"nodes": dict(obj.nodes)}
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    raise WireError(f"cannot encode fields of {type(obj).__name__}")


def _obj_build(cls, fields: dict):
    """Field dict -> object (decoder side)."""
    import itertools

    from ..exec.plan import Plan
    from ..types.batch import HostBatch
    from ..types.dtypes import DataType
    from ..types.relation import Relation
    from ..types.strings import StringDictionary

    if cls is Relation:
        return Relation([(n, DataType(v)) for n, v in fields["items"]])
    if cls is StringDictionary:
        return StringDictionary(fields["strings"])
    if cls is HostBatch:
        return HostBatch(
            relation=fields["relation"],
            cols={n: tuple(ps) for n, ps in fields["cols"].items()},
            length=fields["length"],
            dicts=fields["dicts"],
            eow=fields["eow"],
            eos=fields["eos"],
        )
    if cls is Plan:
        nodes = fields["nodes"]
        start = (max(nodes) + 1) if nodes else 0
        return Plan(nodes=nodes, _counter=itertools.count(start))
    return cls(**fields)


# -- encoder -----------------------------------------------------------------


def _enc(obj, out: list) -> None:
    from ..types.dtypes import DataType

    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, int) and not isinstance(obj, bool):
        if -(2**63) <= obj < 2**63:
            out.append(b"I")
            out.append(_I64.pack(obj))
        else:  # u128 values etc.
            s = str(obj).encode()
            out.append(b"J")
            out.append(_U32.pack(len(s)))
            out.append(s)
    elif isinstance(obj, float):
        out.append(b"D")
        out.append(_F64.pack(obj))
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(b"S")
        out.append(_U32.pack(len(b)))
        out.append(b)
    elif isinstance(obj, bytes):
        out.append(b"B")
        out.append(_U32.pack(len(obj)))
        out.append(obj)
    elif isinstance(obj, torch.Tensor):
        raise WireError(
            "a torch.Tensor is not wire-encodable; move it to the host "
            "as numpy first"
        )
    elif isinstance(obj, (np.ndarray, np.generic)):
        # np.ascontiguousarray promotes 0-d to 1-d — preserve 0-d shapes.
        arr = np.asarray(obj)
        if not arr.flags["C_CONTIGUOUS"]:
            arr = np.ascontiguousarray(arr)
        if arr.dtype == object:  # decoded string columns etc.
            out.append(b"G")
            out.append(_U16.pack(arr.ndim))
            for d in arr.shape:
                out.append(_U32.pack(d))
            for v in arr.reshape(-1).tolist():
                _enc(v, out)
            return
        dt = arr.dtype.str.encode()
        out.append(b"A")
        out.append(_U16.pack(len(dt)))
        out.append(dt)
        out.append(b"\x01" if isinstance(obj, np.generic) else b"\x00")
        out.append(_U16.pack(arr.ndim))
        for d in arr.shape:
            out.append(_U32.pack(d))
        out.append(arr.tobytes())
    elif isinstance(obj, tuple):
        out.append(b"U")
        out.append(_U32.pack(len(obj)))
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, (set, frozenset)):
        # Sets would decode as lists — a silent type change the in-process
        # bus never makes; reject at the publisher instead.
        raise WireError(
            "sets are not wire-encodable; send a sorted list/tuple"
        )
    elif isinstance(obj, list):
        out.append(b"L")
        out.append(_U32.pack(len(obj)))
        for v in obj:
            _enc(v, out)
    elif isinstance(obj, dict):
        out.append(b"M")
        out.append(_U32.pack(len(obj)))
        for k, v in obj.items():
            _enc(k, out)
            _enc(v, out)
    elif isinstance(obj, DataType):
        b = obj.value.encode()
        out.append(b"E")
        out.append(_U16.pack(len(b)))
        out.append(b)
    else:
        _, ids = _tables()
        tid = ids.get(type(obj))
        if tid is None:
            raise WireError(
                f"type {type(obj).__name__} is not wire-registered"
            )
        out.append(b"O")
        out.append(_U16.pack(tid))
        _enc(_obj_fields(obj), out)


def encode(obj) -> bytes:
    out: list = [bytes([WIRE_VERSION])]
    _enc(obj, out)
    return b"".join(out)


# -- decoder -----------------------------------------------------------------


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise WireError("truncated message")
        self.pos += n
        return b


def _dec(r: _Reader):
    from ..types.dtypes import DataType

    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"I":
        return _I64.unpack(r.take(8))[0]
    if tag == b"J":
        (n,) = _U32.unpack(r.take(4))
        return int(r.take(n).decode())
    if tag == b"D":
        return _F64.unpack(r.take(8))[0]
    if tag == b"S":
        (n,) = _U32.unpack(r.take(4))
        return r.take(n).decode()
    if tag == b"B":
        (n,) = _U32.unpack(r.take(4))
        return r.take(n)
    if tag == b"A":
        (dl,) = _U16.unpack(r.take(2))
        dt = np.dtype(r.take(dl).decode())
        scalar = r.take(1) == b"\x01"
        (ndim,) = _U16.unpack(r.take(2))
        shape = tuple(_U32.unpack(r.take(4))[0] for _ in range(ndim))
        count = 1
        for d in shape:
            count *= d
        arr = np.frombuffer(
            r.take(count * dt.itemsize), dtype=dt
        ).reshape(shape).copy()
        return arr[()] if scalar and ndim == 0 else arr
    if tag == b"G":
        (ndim,) = _U16.unpack(r.take(2))
        shape = tuple(_U32.unpack(r.take(4))[0] for _ in range(ndim))
        count = 1
        for d in shape:
            count *= d
        # Every element takes >= 1 byte on the wire: a corrupted shape
        # must fail as truncation, not as a giant up-front allocation.
        if count > len(r.buf) - r.pos:
            raise WireError("object-array count exceeds buffer")
        # Decode into a list FIRST: allocation stays proportional to
        # elements actually present (truncation fails fast) instead of
        # an up-front count-sized pointer array from a hostile shape.
        vals = [_dec(r) for _ in range(count)]
        arr = np.empty(count, dtype=object)
        for i, v in enumerate(vals):
            arr[i] = v  # per-element: sequences must not broadcast
        return arr.reshape(shape)
    if tag == b"U":
        (n,) = _U32.unpack(r.take(4))
        return tuple(_dec(r) for _ in range(n))
    if tag == b"L":
        (n,) = _U32.unpack(r.take(4))
        return [_dec(r) for _ in range(n)]
    if tag == b"M":
        (n,) = _U32.unpack(r.take(4))
        return {_dec(r): _dec(r) for _ in range(n)}
    if tag == b"E":
        (n,) = _U16.unpack(r.take(2))
        return DataType(r.take(n).decode())
    if tag == b"O":
        (tid,) = _U16.unpack(r.take(2))
        types, _ = _tables()
        if tid >= len(types):
            raise WireError(f"unknown wire type id {tid}")
        fields = _dec(r)
        return _obj_build(types[tid], fields)
    raise WireError(f"unknown wire tag {tag!r}")


def _dec_guarded(r: _Reader):
    """_dec with the failure surface promised to transports: ANY
    malformed input raises WireError. Corruption otherwise leaks
    ValueError/UnicodeDecodeError/KeyError/TypeError/struct.error out
    of the tag handlers and object constructors (fuzz-verified), and
    transport read loops only treat WireError/ConnectionError as
    "drop this peer"."""
    try:
        return _dec(r)
    except WireError:
        raise
    except (ValueError, KeyError, TypeError, AttributeError, IndexError,
            OverflowError, UnicodeDecodeError, struct.error,
            RecursionError, MemoryError) as e:
        raise WireError(
            f"malformed message: {type(e).__name__}: {e}"
        ) from None


def decode(buf: bytes):
    if not buf:
        raise WireError("empty message")
    if buf[0] != WIRE_VERSION:
        raise WireError(f"wire version {buf[0]} != {WIRE_VERSION}")
    r = _Reader(buf)
    r.pos = 1
    obj = _dec_guarded(r)
    if r.pos != len(buf):
        raise WireError(f"{len(buf) - r.pos} trailing bytes")
    return obj
