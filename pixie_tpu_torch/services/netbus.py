"""Socket transport for the message bus: agents in separate processes.

Reference parity: the control plane is NATS pub/sub with protobuf
envelopes (``src/common/event/nats.h:36-60``; ``launch_query.go:36``) and
the data plane is gRPC streaming (``grpc_router.{h,cc}``). Here one
framed-TCP layer carries both: a ``BusServer`` wraps the broker-side
in-process ``MessageBus`` and remote ``RemoteBus`` clients mirror the bus
API (subscribe/publish), with every frame encoded by the versioned wire
codec (``wire.py``) — no pickle crosses the socket.

Frames: 4-byte little-endian length + wire-encoded dict
{"op": "pub"|"sub"|"unsub", "topic": str, "msg": ...?, "sid": int?}.

Wire telemetry (``bus_telemetry`` flag, services/busstats.py): both
endpoints count frames/bytes per peer and direction off ``_send_frame``
/ ``_recv_frame_sized`` returns, request RTTs, send-stall time under
the send lock, and connect/drop/auth-failure events — the cluster's
wire-byte ground truth, served via ``busz()`` / ``/debug/busz``.

A port of the JAX package's ``services/netbus.py`` without the fault
injector's hook on ``RemoteBus.publish`` and without ``RemoteBus.sever``
(fault injection is a later slice of the port, as for ``msgbus.py``). Frames carry only host values:
``wire.encode`` refuses a ``torch.Tensor``.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque

from ..config import get_flag
from ..exec import tracectx
from .busstats import BusStats, HANDLER_ERROR_RING, topic_class
from .msgbus import BusTimeout, MessageBus
from .wire import WireError, decode, encode

_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 30


def _harden_socket(sock: socket.socket, send_timeout_s: int = 10) -> None:
    """Transport hardening for both bus endpoints:

    - SO_SNDTIMEO bounds blocking sends so a peer that stops READING
      can't park a sender inside its send lock forever (the timeout
      surfaces as TimeoutError ⊂ OSError and the caller reaps).
    - SO_KEEPALIVE (+ aggressive probe knobs where available) detects
      half-open connections — a peer HOST that died without FIN would
      otherwise leave recv() blocked forever now that reads are
      unbounded (idle is normal on this bus).
    """
    # Every knob best-effort: hardening must never take a connection
    # (or the server's accept loop) down — platforms vary in timeval
    # layout and option support.
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDTIMEO,
            struct.pack("ll", send_timeout_s, 0),
        )
    except OSError:
        pass
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    except OSError:
        pass
    for opt, val in (
        ("TCP_KEEPIDLE", 30), ("TCP_KEEPINTVL", 10), ("TCP_KEEPCNT", 3),
    ):
        if hasattr(socket, opt):
            try:
                sock.setsockopt(socket.IPPROTO_TCP, getattr(socket, opt), val)
            except OSError:
                pass


def _send_frame(sock: socket.socket, obj) -> int:
    """Encode + send one frame; returns the wire bytes written (length
    prefix included) so callers can account without re-encoding."""
    payload = encode(obj)
    if len(payload) > MAX_FRAME:
        # Fail the PUBLISHER visibly; an oversize frame on the wire would
        # instead kill the receiver's connection and silently drop all of
        # its subscriptions.
        raise ValueError(
            f"frame of {len(payload)} bytes exceeds MAX_FRAME {MAX_FRAME}; "
            "chunk the payload"
        )
    sock.sendall(_LEN.pack(len(payload)) + payload)
    return _LEN.size + len(payload)


#: Required keys per frame op (both directions share the codec).
_FRAME_KEYS = {
    "pub": ("topic", "msg"),
    "sub": ("topic", "sid"),
    "unsub": ("sid",),
    "msg": ("sid", "msg"),
}


def _recv_frame(sock: socket.socket):
    return _recv_frame_sized(sock)[0]


def _recv_frame_sized(sock: socket.socket):
    """One frame off the wire as ``(frame | None, wire_bytes)`` — the
    byte count feeds the per-peer recv accounting."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None, 0
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise ConnectionError(f"frame of {n} bytes exceeds limit")
    payload = _recv_exact(sock, n)
    if payload is None:
        return None, _LEN.size
    frame = decode(payload)
    # Schema gate at the frame boundary: a frame that decodes but has
    # the wrong SHAPE (non-dict, non-str op/topic, non-int sid) is just
    # as malformed as undecodable bytes — fail it here as WireError so
    # the read loops keep their narrow except lists and no handler runs
    # on hostile input (e.g. bus.subscribe before an unhashable-sid
    # lookup raised would leak the subscription forever).
    if not isinstance(frame, dict):
        raise WireError(f"frame is {type(frame).__name__}, not a dict")
    op = frame.get("op")
    if not isinstance(op, str):
        raise WireError("frame has no string 'op'")
    required = _FRAME_KEYS.get(op, ())
    for key in required:
        if key not in frame:
            raise WireError(f"'{op}' frame missing {key!r}")
    if "topic" in frame and not isinstance(frame["topic"], str):
        raise WireError("frame 'topic' is not a string")
    if "sid" in frame and not isinstance(frame["sid"], int):
        raise WireError("frame 'sid' is not an int")
    return frame, _LEN.size + n


def _recv_exact(sock: socket.socket, n: int):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class BusServer:
    """Bridges a local MessageBus to remote RemoteBus clients.

    With ``secret`` set (or the ``bus_secret`` flag), a client's FIRST
    frame must be ``{"op": "auth", "token": ...}`` carrying a valid
    bearer token (``auth.sign_token``); anything else closes the
    connection — the netbus trust boundary (the reference checks JWT
    claims at every gRPC service edge, authcontext/context.go:38).
    """

    def __init__(self, bus: MessageBus, host: str = "127.0.0.1", port: int = 0,
                 secret: str | None = None):
        self.bus = bus
        self.secret = get_flag("bus_secret") if secret is None else secret
        self._srv = socket.create_server((host, port))
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._clients: list = []
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._accept_loop, name="busserver", daemon=True
        )
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            try:
                # Same hardening as the client side: bounded sends (a
                # non-reading client can't park forwarders in sendall —
                # the TimeoutError ⊂ OSError path in _send closes and
                # drops its subscriptions) + keepalive for half-open
                # peers. Per-client setup failure drops THAT client,
                # never the acceptor.
                _harden_socket(sock)
                client = _ClientConn(self, sock)
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            with self._lock:
                self._clients.append(client)
            client.start()

    def _drop(self, client) -> None:
        with self._lock:
            if client in self._clients:
                self._clients.remove(client)

    def busz(self) -> list[dict]:
        """Per-connection wire accounting for ``/debug/busz`` (the
        metric-label peer is the auth subject; THIS is where individual
        connections stay distinguishable)."""
        with self._lock:
            clients = list(self._clients)
        out = []
        for c in clients:
            try:
                addr = c.sock.getpeername()
                remote = f"{addr[0]}:{addr[1]}"
            except OSError:
                remote = "?"
            out.append({
                "remote": remote,
                "peer": c.peer,
                "subscriptions": len(c._subs),
                **c._sent_counts,
                **c._recv_counts,
            })
        return out

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            clients = list(self._clients)
        for c in clients:
            c.close()


class _ClientConn:
    """Server-side state for one remote client."""

    def __init__(self, server: BusServer, sock: socket.socket):
        self.server = server
        self.sock = sock
        # Per-peer wire accounting: the metric-label peer is the auth
        # subject ("anon" without a secret — bounded cardinality); the
        # per-connection detail below feeds BusServer.busz() only.
        self.peer = "client"
        # Split by writer thread: sent counters mutate under _send_lock
        # (any dispatcher thread may _send), recv counters only on the
        # read-loop thread — no cross-thread writes to either dict.
        self._sent_counts = {"frames_sent": 0, "bytes_sent": 0}
        self._recv_counts = {"frames_recv": 0, "bytes_recv": 0}
        self._send_lock = threading.Lock()
        # Guards _subs + _closed: close() can run from any subscription
        # dispatcher thread (via a _send failure) while the read loop
        # registers new subscriptions — an unlocked insert racing close
        # would leak that subscription's dispatcher thread forever.
        self._subs_lock = threading.Lock()
        self._closed = False
        self._subs: dict[int, object] = {}  # sid -> Subscription
        self.auth_ctx = None  # AuthContext once authenticated
        self._thread = threading.Thread(
            target=self._read_loop, name="busserver-client", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def _read_loop(self) -> None:
        from .auth import ANONYMOUS, AuthError, verify_token

        st = self.server.bus.stats
        try:
            if self.server.secret:
                # Authentication handshake gates EVERYTHING else.
                frame = self._recv_counted(st)
                if frame is None or frame.get("op") != "auth":
                    if st is not None:
                        st.on_conn_event(self.peer, "auth_failure")
                    self._send({"op": "auth_err", "error": "auth required"})
                    return
                try:
                    self.auth_ctx = verify_token(
                        self.server.secret, frame.get("token")
                    )
                except AuthError as e:
                    if st is not None:
                        st.on_conn_event(self.peer, "auth_failure")
                    self._send({"op": "auth_err", "error": str(e)})
                    return
                self.peer = self.auth_ctx.subject or "anon"
                self._send({"op": "auth_ok", "sub": self.auth_ctx.subject})
            else:
                self.auth_ctx = ANONYMOUS
                self.peer = "anon"
            if st is not None:
                st.on_conn_event(self.peer, "connect")
            while True:
                frame = self._recv_counted(st)
                if frame is None:
                    break
                op = frame.get("op")
                if op == "auth":
                    # Token offered to a no-secret server (or re-auth):
                    # acknowledge so the client handshake completes.
                    self._send({"op": "auth_ok", "sub": ""})
                    continue
                if op == "pub":
                    self.server.bus.publish(frame["topic"], frame["msg"])
                elif op == "sub":
                    sid, topic = frame["sid"], frame["topic"]

                    def fwd(msg, _sid=sid, _topic=topic):
                        self._send({"op": "msg", "sid": _sid, "msg": msg})

                    sub = self.server.bus.subscribe(topic, fwd)
                    with self._subs_lock:
                        if self._closed:
                            pass  # lost the race; unsubscribe below
                        else:
                            self._subs[sid] = sub
                            sub = None
                    if sub is not None:
                        sub.unsubscribe()
                elif op == "unsub":
                    with self._subs_lock:
                        sub = self._subs.pop(frame["sid"], None)
                    if sub is not None:
                        sub.unsubscribe()
        except (ConnectionError, OSError, WireError):
            # WireError covers corrupted bytes AND wrong-schema frames
            # (validated in _recv_frame) — drop the connection; real
            # handler bugs still raise visibly.
            if st is not None:
                st.on_conn_event(self.peer, "drop")
        finally:
            self.close()

    def _recv_counted(self, st):
        frame, nb = _recv_frame_sized(self.sock)
        if nb:
            # Single writer: only the read-loop thread touches the
            # recv counters (the send pair lives under _send_lock).
            self._recv_counts["frames_recv"] += 1
            self._recv_counts["bytes_recv"] += nb
            if st is not None:
                st.on_frame(self.peer, "recv", nb)
        return frame

    def _send(self, obj) -> None:
        st = self.server.bus.stats
        try:
            t0 = time.monotonic()
            with self._send_lock:
                stall_s = time.monotonic() - t0
                n = _send_frame(self.sock, obj)
                self._sent_counts["frames_sent"] += 1
                self._sent_counts["bytes_sent"] += n
            if st is not None:
                st.on_send_stall(self.peer, stall_s)
                st.on_frame(self.peer, "send", n)
        except (ConnectionError, OSError):
            if st is not None:
                st.on_conn_event(self.peer, "drop")
            self.close()

    def close(self) -> None:
        with self._subs_lock:
            self._closed = True
            subs = list(self._subs.values())
            self._subs.clear()
        for sub in subs:
            sub.unsubscribe()
        try:
            self.sock.close()
        except OSError:
            pass
        self.server._drop(self)


class _RemoteSubscription:
    """One remote subscription with its own dispatcher thread (mirrors
    msgbus.Subscription: a slow handler must not block other handlers or
    the socket read loop — e.g. query execution vs. cancellation)."""

    _SENTINEL = object()

    def __init__(self, bus: "RemoteBus", sid: int, fn, topic: str = ""):
        import queue as _queue

        self._bus = bus
        self._sid = sid
        self._fn = fn
        self.topic = topic
        self._cls = topic_class(topic) if topic else "?"
        self._hw = 0
        self._q: "_queue.Queue" = _queue.Queue()
        self._thread = threading.Thread(
            target=self._run, name=f"remotebus-sub-{sid}", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        st = self._bus.stats
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            if st is not None:
                msg, enq_t = item
                lag_s = time.monotonic() - enq_t
                t0 = time.monotonic()
            else:
                msg = item
            err = False
            try:
                # Same envelope binding as msgbus.Subscription: the
                # distributed trace context survives the TCP hop (the
                # wire codec carries the _trace_ctx dict unchanged).
                with tracectx.bound(tracectx.extract(msg)):
                    self._fn(msg)
            except Exception as e:  # handler errors never kill the dispatcher
                err = True
                self._bus._on_handler_error(self.topic, e)
            if st is not None:
                st.on_handled(
                    self._cls, self.topic, lag_s,
                    time.monotonic() - t0, error=err,
                )

    def _deliver(self, msg) -> None:
        st = self._bus.stats
        if st is not None:
            depth = self._q.qsize() + 1
            if depth > self._hw:
                self._hw = depth
            st.on_deliver(self._cls, 0, depth)
            self._q.put((msg, time.monotonic()))
        else:
            self._q.put(msg)

    def unsubscribe(self) -> None:
        self._bus._unsubscribe(self._sid)
        self._q.put(self._SENTINEL)


class RemoteBus:
    """Client-side bus mirror: same subscribe/publish surface as
    MessageBus, carried over one TCP connection to a BusServer."""

    def __init__(self, host: str, port: int, connect_timeout_s: float = 10.0,
                 token: str | None = None):
        # Wire accounting peer label: the broker endpoint this client
        # dialed (config-bounded cardinality — one broker per deploy).
        # host/port kept separately so HA clients can re-dial the same
        # (or a failover) endpoint after a broker death (api.Client).
        self.host = host
        self.port = port
        self.peer = f"{host}:{port}"
        self.stats: BusStats | None = (
            BusStats() if get_flag("bus_telemetry") else None
        )
        self.handler_errors: deque = deque(maxlen=HANDLER_ERROR_RING)
        self._handler_errors_total = 0
        self.sock = socket.create_connection((host, port), connect_timeout_s)
        # create_connection leaves its timeout ARMED on the socket; the
        # read loop would then treat any 10s-idle connection as dead
        # (TimeoutError ⊂ OSError) and silently self-close — streams
        # with a stalled producer died exactly this way. Receives must
        # block forever (idle is normal); SENDS stay bounded via
        # SO_SNDTIMEO so a wedged server can't hang publishers inside
        # _send_lock.
        self.sock.settimeout(None)
        _harden_socket(self.sock, send_timeout_s=max(int(connect_timeout_s), 1))
        self._send_lock = threading.Lock()
        self._lock = threading.Lock()
        self._handlers: dict[int, object] = {}  # sid -> callable
        self._next_sid = 1
        self._closed = threading.Event()
        # Mint a token from the shared secret when the caller brings
        # none (deploy processes share the bus_secret flag/env).
        if token is None and get_flag("bus_secret"):
            from .auth import sign_token

            token = sign_token(get_flag("bus_secret"), "remotebus")
        if token:
            # Handshake BEFORE the read loop owns the socket: the server
            # answers auth_ok or auth_err+close, so a bad token fails
            # loudly at connect instead of silently dropping frames.
            self.sock.settimeout(connect_timeout_s)
            n = _send_frame(self.sock, {"op": "auth", "token": token})
            if self.stats is not None:
                self.stats.on_frame(self.peer, "send", n)
            reply, nb = _recv_frame_sized(self.sock)
            if self.stats is not None and nb:
                self.stats.on_frame(self.peer, "recv", nb)
            if not (isinstance(reply, dict) and reply.get("op") == "auth_ok"):
                err = (reply or {}).get("error", "connection closed")
                if self.stats is not None:
                    self.stats.on_conn_event(self.peer, "auth_failure")
                self.sock.close()
                raise ConnectionError(f"netbus auth failed: {err}")
            self.sock.settimeout(None)
        if self.stats is not None:
            self.stats.on_conn_event(self.peer, "connect")
        self._thread = threading.Thread(
            target=self._read_loop, name="remotebus", daemon=True
        )
        self._thread.start()

    def subscribe(self, topic: str, fn) -> _RemoteSubscription:
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            sub = _RemoteSubscription(self, sid, fn, topic=topic)
            self._handlers[sid] = sub
        self._send({"op": "sub", "topic": topic, "sid": sid})
        return sub

    def publish(self, topic: str, msg: dict) -> int:
        if self.stats is not None:
            self.stats.on_publish(topic, msg)
        msg = tracectx.attach(msg)  # envelope parity with MessageBus
        self._send({"op": "pub", "topic": topic, "msg": msg})
        return 1

    def request(self, topic: str, msg: dict, timeout_s: float = 5.0) -> dict:
        """Request/reply over the bridge (MessageBus.request mirror).

        The publish-count check is impossible remotely; a missing
        responder surfaces as the timeout instead.
        """
        import queue as _queue
        import uuid as _uuid

        st = self.stats
        inbox = f"_inbox.{_uuid.uuid4().hex}"
        q: _queue.Queue = _queue.Queue()
        sub = self.subscribe(inbox, q.put)
        t0 = time.monotonic()
        try:
            self.publish(topic, {**msg, "_reply_to": inbox})
            reply = q.get(timeout=timeout_s)
            if st is not None:
                st.on_request(self.peer, time.monotonic() - t0)
            return reply
        except _queue.Empty:
            if st is not None:
                st.on_request(self.peer, time.monotonic() - t0,
                              error=True)
            raise BusTimeout(
                f"no reply from {topic!r} in {timeout_s}s"
            ) from None
        finally:
            sub.unsubscribe()

    def _unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._handlers.pop(sid, None)
        try:
            self._send({"op": "unsub", "sid": sid})
        except (ConnectionError, OSError):
            pass  # bus already closed; the server reaps on disconnect

    def _send(self, obj) -> None:
        if self._closed.is_set():
            raise ConnectionError("remote bus closed")
        st = self.stats
        try:
            t0 = time.monotonic()
            with self._send_lock:
                stall_s = time.monotonic() - t0
                n = _send_frame(self.sock, obj)
            if st is not None:
                st.on_send_stall(self.peer, stall_s)
                st.on_frame(self.peer, "send", n)
        except (ConnectionError, OSError):
            # A failed/timed-out send may have written a PARTIAL frame:
            # the stream is desynced for good. Poison the bus so every
            # later caller fails fast instead of corrupting the wire.
            if st is not None and not self._closed.is_set():
                st.on_conn_event(self.peer, "drop")
            self.close()
            raise

    def _on_handler_error(self, topic: str, e: Exception) -> None:
        with self._lock:
            self.handler_errors.append((topic, e, time.time_ns()))
            self._handler_errors_total += 1

    def busz(self) -> dict:
        """The ``/debug/busz`` surface for this bus (MessageBus.busz
        mirror): stat rows, live subscription queue state, recent
        handler errors."""
        st = self.stats
        with self._lock:
            subs = list(self._handlers.values())
            recent = [
                {"topic": t, "error": repr(e), "unix_ns": ns}
                for t, e, ns in self.handler_errors
            ]
            errors_total = self._handler_errors_total
        queues: dict[str, dict] = {}
        for s in subs:
            ent = queues.setdefault(
                s._cls, {"subscriptions": 0, "depth": 0, "high_water": 0}
            )
            ent["subscriptions"] += 1
            ent["depth"] = max(ent["depth"], s._q.qsize())
            ent["high_water"] = max(ent["high_water"], s._hw)
        if st is not None:
            for cls, hw in st.queue_high_water().items():
                ent = queues.setdefault(
                    cls, {"subscriptions": 0, "depth": 0, "high_water": 0}
                )
                ent["high_water"] = max(ent["high_water"], hw)
        return {
            "rows": st.snapshot() if st is not None else [],
            "queues": queues,
            "handler_errors_total": errors_total,
            "recent_errors": recent,
        }

    def _read_loop(self) -> None:
        st = self.stats
        try:
            while True:
                frame, nb = _recv_frame_sized(self.sock)
                if st is not None and nb:
                    st.on_frame(self.peer, "recv", nb)
                if frame is None:
                    break
                if frame.get("op") == "msg":
                    with self._lock:
                        sub = self._handlers.get(frame["sid"])
                    if sub is not None:
                        sub._deliver(frame["msg"])
        except (ConnectionError, OSError, WireError):
            # WireError covers corrupted bytes AND wrong-schema frames
            # (validated in _recv_frame) — drop the connection; real
            # handler bugs still raise visibly.
            pass
        finally:
            # An orderly close() sets _closed BEFORE the socket dies;
            # anything else reaching here lost the connection.
            if st is not None and not self._closed.is_set():
                st.on_conn_event(self.peer, "drop")
            self._closed.set()
            self._reap_dispatchers()

    def _reap_dispatchers(self) -> None:
        """End every subscription dispatcher thread (connection gone)."""
        with self._lock:
            subs = list(self._handlers.values())
            self._handlers.clear()
        for sub in subs:
            sub._q.put(sub._SENTINEL)

    def close(self) -> None:
        self._closed.set()
        try:
            self.sock.close()
        except OSError:
            pass
        self._reap_dispatchers()
