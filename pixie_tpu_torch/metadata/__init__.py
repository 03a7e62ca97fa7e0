"""K8s metadata subsystem: entity state + UPID resolution UDFs.

Reference parity: ``src/shared/metadata/`` (K8sMetadataState
``metadata_state.h:47``, AgentMetadataState ``:251`` mapping UPID ->
PIDInfo -> pod/service) and the metadata UDFs in
``src/carnot/funcs/metadata/``. A port of the JAX package's
``metadata/``: the state, the watcher and the resolver are copies; the
UPID functions look up a host-built hash table on the device.
"""

from .state import ContainerInfo, MetadataState, PodInfo, ServiceInfo, UPID

__all__ = ["ContainerInfo", "MetadataState", "PodInfo", "ServiceInfo", "UPID"]
