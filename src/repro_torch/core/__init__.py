"""repro_torch.core — DRust's ownership-guided DSM, protocol-exact (carried
over unchanged from ``repro.core``), plus the PyTorch-facing ownership
state store (``torchstate``).

Entry points:
  * ``Cluster(n, backend=...)`` — simulated deployment (drust | gam | grappa)
  * ``ProtocolBackend`` — the backend-generic verb ABC all three implement
  * scoped guards — ``with box.read(th) as v:`` / ``with box.write(th) as
    w:`` / ``with cluster.region(th) as r:`` (see ``protocol``)
  * ``DrustRuntime`` — the coherence protocol engine (Algorithms 1-8)
  * ``OwnedState`` — colored, borrow-checked distributed trees of tensors
"""

from . import addr
from .baselines import GamBackend, GrappaBackend, GHandle
from .cache import LocalCache
from .channel import Channel
from .fault import RecoveryManager, RecoveryReport, Replicator
from .heap import GlobalHeap, Obj, Partition
from .net import (CostModel, IOBatch, NetStats, ServerLostError, Sim,
                  WritebackQueue)
from .ownership import (BorrowError, DBox, DrustBackend, DrustRuntime, MutRef,
                        Ref, StackRef)
from .protocol import (ProtocolBackend, ReadGuard, Region, WriteGuard,
                       backend_caps, backend_class)
from .runtime import (Cluster, CoalescePolicy, DerefCoalescer,
                      GlobalController, Scheduler, Thread)
from .sync import DAtomic, DMutex, DRwLock
from .torchstate import (ColoredAddr, OwnedState, ReplicaSlot, StateCache,
                         StateMutRef, StateRef)

__all__ = [
    "addr", "backend_caps", "backend_class", "BorrowError", "Channel",
    "Cluster", "CoalescePolicy", "ColoredAddr", "CostModel",
    "DAtomic", "DBox", "DerefCoalescer", "DMutex", "DRwLock",
    "DrustBackend", "DrustRuntime", "GamBackend",
    "GHandle", "GlobalController", "GlobalHeap", "GrappaBackend", "IOBatch",
    "LocalCache", "MutRef", "NetStats", "Obj", "OwnedState", "Partition",
    "ProtocolBackend", "ReadGuard", "RecoveryManager", "RecoveryReport",
    "Ref", "Region", "ReplicaSlot",
    "Replicator", "Scheduler", "ServerLostError", "Sim", "StackRef",
    "StateCache", "StateMutRef", "StateRef", "Thread", "WritebackQueue",
    "WriteGuard",
]
