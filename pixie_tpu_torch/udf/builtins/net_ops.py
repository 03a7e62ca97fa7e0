"""Network UDFs (dictionary-side).

Reference parity: ``src/carnot/funcs/net/net_ops.h`` — ``NSLookupUDF``
(reverse-DNS with a per-process cache) and CIDR/IP helpers. Lookups run
once per distinct address in the dictionary; resolution failures (or
sandboxed environments with no resolver) fall back to the input address,
matching the reference's cache-miss behavior.
"""

from __future__ import annotations

import ipaddress
import socket

from ..udf import BOOLEAN, INT64, STRING, Executor

_NSLOOKUP_CACHE: dict[str, str] = {}
_NSLOOKUP_CACHE_MAX = 1 << 16
_NSLOOKUP_TIMEOUT_S = 1.0
_resolver_pool = None


def _resolver():
    global _resolver_pool
    if _resolver_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _resolver_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="nslookup"
        )
    return _resolver_pool


def nslookup(addr: str) -> str:
    hit = _NSLOOKUP_CACHE.get(addr)
    if hit is not None:
        return hit
    # NB: never socket.setdefaulttimeout here — that is process-global
    # state and would put read timeouts on every other socket in the
    # process (the TCP bus transport included). gethostbyaddr has no
    # per-call timeout, so the lookup runs on a resolver pool with a
    # result deadline: a dead resolver costs ~1s per distinct address,
    # not a resolver-timeout each (HOST_DICT runs this per DISTINCT
    # string at plan-bind time).
    from concurrent.futures import TimeoutError as FutTimeout

    try:
        fut = _resolver().submit(socket.gethostbyaddr, addr)
        name = fut.result(timeout=_NSLOOKUP_TIMEOUT_S)[0]
    except (OSError, ValueError, FutTimeout):
        name = addr
    if len(_NSLOOKUP_CACHE) >= _NSLOOKUP_CACHE_MAX:
        _NSLOOKUP_CACHE.clear()
    _NSLOOKUP_CACHE[addr] = name
    return name


def ip_to_int(addr: str) -> int:
    """IPv4 dotted-quad -> int (0 on parse failure)."""
    try:
        return int(ipaddress.IPv4Address(addr))
    except (ipaddress.AddressValueError, ValueError):
        return 0


def cidr_contains(addr: str, cidr) -> bool:
    try:
        return ipaddress.ip_address(addr) in ipaddress.ip_network(
            str(cidr), strict=False
        )
    except ValueError:
        return False


def register(reg):
    reg.scalar(
        "nslookup", (STRING,), STRING, nslookup,
        executor=Executor.HOST_DICT, dict_arg=0,
        doc="Reverse-DNS lookup (cached; falls back to the address).",
    )
    reg.scalar(
        "ip_to_int", (STRING,), INT64, ip_to_int,
        executor=Executor.HOST_DICT, dict_arg=0,
        doc="IPv4 address -> integer (0 when unparseable).",
    )
    reg.scalar(
        "cidr_contains", (STRING, STRING), BOOLEAN, cidr_contains,
        executor=Executor.HOST_DICT, dict_arg=0,
        doc="True when the address lies inside the (literal) CIDR block.",
    )
