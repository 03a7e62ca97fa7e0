"""Agent metadata state: k8s entities + UPID -> entity mapping.

Reference parity: ``src/shared/metadata/metadata_state.h`` —
``K8sMetadataState`` (:47; pods/services/namespaces by UID and IP) and
``AgentMetadataState`` (:251; UPID -> PIDInfo :290). The reference builds
this from NATS ``ResourceUpdate`` streams + /proc scans
(``state_manager.h:115``); here updates arrive via the ``apply_update``
dict API (the receiving surface a control plane feeds).

UPID is the 128-bit {asid(u32), pid(u32), start_ticks(u64)} join key
between traces and k8s metadata (``src/shared/upid``); device-side it is
an (hi, lo) uint64 pair.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class UPID:
    asid: int
    pid: int
    start_ticks: int

    @property
    def hi(self) -> int:
        return ((self.asid & 0xFFFFFFFF) << 32) | (self.pid & 0xFFFFFFFF)

    @property
    def lo(self) -> int:
        return self.start_ticks & 0xFFFFFFFFFFFFFFFF

    @property
    def value(self) -> int:
        return (self.hi << 64) | self.lo

    def __str__(self) -> str:
        return f"{self.asid}:{self.pid}:{self.start_ticks}"

    @classmethod
    def parse(cls, s: str) -> "UPID":
        asid, pid, ticks = s.split(":")
        return cls(int(asid), int(pid), int(ticks))


@dataclass
class PodInfo:
    uid: str
    name: str
    namespace: str
    node_name: str = ""
    phase: str = "RUNNING"
    ip: str = ""
    service_uids: tuple = ()
    start_time_ns: int = 0
    stop_time_ns: int = 0  # 0 = still alive

    @property
    def qualified_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class ServiceInfo:
    uid: str
    name: str
    namespace: str
    cluster_ip: str = ""

    @property
    def qualified_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class ContainerInfo:
    cid: str
    name: str
    pod_uid: str


@dataclass
class _PIDInfo:
    upid: UPID
    pod_uid: str
    container_id: str = ""
    cmdline: str = ""


@dataclass
class MetadataState:
    """Mutable metadata snapshot store (thread-safe via a coarse lock).

    ``epoch`` increments on every mutation so bound query closures can be
    invalidated (queries snapshot the state at compile/bind time — the
    reference similarly hands each query an AgentMetadataState snapshot).
    """

    asid: int = 0
    pods: dict = field(default_factory=dict)  # uid -> PodInfo
    services: dict = field(default_factory=dict)  # uid -> ServiceInfo
    containers: dict = field(default_factory=dict)  # cid -> ContainerInfo
    namespaces: set = field(default_factory=set)
    pids: dict = field(default_factory=dict)  # (hi, lo) -> _PIDInfo
    ip_to_pod: dict = field(default_factory=dict)  # ip -> pod uid
    epoch: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    # -- update application (the ResourceUpdate-handler surface) -------------
    def add_pod(self, uid, name, namespace, node_name="", ip="",
                service_uids=(), phase="RUNNING", start_time_ns=0):
        with self._lock:
            self.pods[uid] = PodInfo(
                uid=uid, name=name, namespace=namespace, node_name=node_name,
                ip=ip, service_uids=tuple(service_uids), phase=phase,
                start_time_ns=start_time_ns,
            )
            self.namespaces.add(namespace)
            if ip:
                self.ip_to_pod[ip] = uid
            self.epoch += 1

    def add_service(self, uid, name, namespace, cluster_ip=""):
        with self._lock:
            self.services[uid] = ServiceInfo(uid, name, namespace, cluster_ip)
            self.namespaces.add(namespace)
            self.epoch += 1

    def add_container(self, cid, name, pod_uid):
        with self._lock:
            self.containers[cid] = ContainerInfo(cid, name, pod_uid)
            self.epoch += 1

    def add_process(self, upid: UPID, pod_uid: str, container_id: str = "",
                    cmdline: str = ""):
        with self._lock:
            self.pids[(upid.hi, upid.lo)] = _PIDInfo(
                upid, pod_uid, container_id, cmdline
            )
            self.epoch += 1

    def remove_pod(self, uid, stop_time_ns: int = 1):
        with self._lock:
            if uid in self.pods:
                self.pods[uid].stop_time_ns = stop_time_ns
            self.epoch += 1

    def apply_update(self, update: dict):
        """Apply one ResourceUpdate-shaped dict (the NATS message analog):
        {"kind": "pod"|"service"|"container"|"process", ...fields}."""
        kind = update.get("kind")
        u = {k: v for k, v in update.items() if k != "kind"}
        if kind == "pod":
            self.add_pod(**u)
        elif kind == "service":
            self.add_service(**u)
        elif kind == "container":
            self.add_container(**u)
        elif kind == "process":
            upid = u.pop("upid")
            if isinstance(upid, str):
                upid = UPID.parse(upid)
            self.add_process(upid, **u)
        else:
            raise ValueError(f"unknown metadata update kind {kind!r}")

    # -- query-side accessors ------------------------------------------------
    def pod_of_upid(self, hi: int, lo: int) -> Optional[PodInfo]:
        p = self.pids.get((hi, lo))
        return self.pods.get(p.pod_uid) if p else None

    def service_of_pod(self, pod: PodInfo) -> Optional[ServiceInfo]:
        for suid in pod.service_uids:
            svc = self.services.get(suid)
            if svc:
                return svc
        return None

    def snapshot_entries(self):
        """(upid_his, upid_los, per-attribute string lists) for UDF binding."""
        with self._lock:
            entries = list(self.pids.values())
            out = {
                "hi": [p.upid.hi for p in entries],
                "lo": [p.upid.lo for p in entries],
                "pod_id": [], "pod_name": [], "namespace": [], "node_name": [],
                "service_id": [], "service_name": [], "container_id": [],
                "container_name": [], "cmdline": [],
            }
            for p in entries:
                pod = self.pods.get(p.pod_uid)
                svc = self.service_of_pod(pod) if pod else None
                cont = self.containers.get(p.container_id)
                out["pod_id"].append(pod.uid if pod else "")
                out["pod_name"].append(pod.qualified_name if pod else "")
                out["namespace"].append(pod.namespace if pod else "")
                out["node_name"].append(pod.node_name if pod else "")
                out["service_id"].append(svc.uid if svc else "")
                out["service_name"].append(svc.qualified_name if svc else "")
                out["container_id"].append(p.container_id)
                out["container_name"].append(cont.name if cont else "")
                out["cmdline"].append(p.cmdline)
            return out
