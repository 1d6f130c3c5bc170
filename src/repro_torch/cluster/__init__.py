"""Mesh-scale deterministic serving: N engine replicas behind a
deterministic router.

PyTorch port of ``repro.cluster``.  The single-engine DVR contract ("same
committed stream regardless of batching") composes to fleet scale only if
the layer above the engine is itself deterministic.  This package adds
that layer: a router whose request->replica assignment is a pure function
of the arrival trace and the replicas' states (radix-prefix affinity with
index tie-breaks and a load guard), replicas that can move committed-prefix
KV blocks between pools (or deterministically recompute them, bitwise the
same by the contract), and a cluster drive loop over per-replica costed
dual-clock runtimes reporting aggregate throughput and goodput off the
shared cost model (``serving.costmodel.H100`` by default).  Replicas on
one card share one params dict; each owns its KV pool.
"""

from repro_torch.cluster.replica import Replica, transfer_prefix
from repro_torch.cluster.router import Cluster, ClusterResult, Router, run_online

__all__ = [
    "Cluster",
    "ClusterResult",
    "Replica",
    "Router",
    "run_online",
    "transfer_prefix",
]
