"""PGAS global heap: per-server partitions, first-fit free-list allocator.

Every server backs one partition of the shared address space (paper Fig. 3).
Objects are real Python payloads (bytes / numpy arrays) tracked with explicit
sizes; allocation returns raw 48-bit global addresses whose partition index
identifies the backing server (``addr.server_of``).

``Obj.ties`` holds the raw addresses of TBox-tied children (affinity groups,
§4.1.3): moving/copying an object transfers its transitive tie-closure in one
batched message.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from . import addr as A


@dataclass
class Obj:
    data: Any
    size: int
    ties: list[int] = field(default_factory=list)   # raw addrs of tied children


class Partition:
    """One server's slice of the global heap."""

    QUARANTINE = 16      # freed blocks sit out this many frees before reuse

    def __init__(self, server: int):
        self.server = server
        self.base, self.limit = A.partition_range(server)
        self._cursor = self.base + 64        # keep 0 offset unused (NULL-safe)
        self._free: list[tuple[int, int]] = []  # (addr, size) reuse list
        self._quarantine: list[tuple[int, int]] = []
        self.objects: dict[int, Obj] = {}
        self.used = 0

    # -- allocation ------------------------------------------------------
    def alloc(self, size: int, data: Any) -> int:
        size = max(1, int(size))
        for i, (a, sz) in enumerate(self._free):
            if sz >= size:
                self._free.pop(i)
                if sz > size:
                    self._free.append((a + size, sz - size))
                self.objects[a] = Obj(data, size)
                self.used += size
                return a
        a = self._cursor
        if a + size > self.limit:
            raise MemoryError(f"server {self.server} heap partition exhausted")
        self._cursor += size
        self.objects[a] = Obj(data, size)
        self.used += size
        return a

    def free(self, raw: int) -> Obj:
        obj = self.objects.pop(raw)
        self.used -= obj.size
        # Deferred reuse: a freed address sits out QUARANTINE frees so a
        # recycled address cannot alias a colored pointer still in flight
        # (the ABA window that B.4's async invalidation also covers).
        self._quarantine.append((raw, obj.size))
        if len(self._quarantine) > self.QUARANTINE:
            self._free.append(self._quarantine.pop(0))
        return obj

    # -- access ----------------------------------------------------------
    def get(self, raw: int) -> Obj:
        return self.objects[raw]

    def contains(self, raw: int) -> bool:
        return raw in self.objects

    @property
    def capacity(self) -> int:
        return self.limit - self.base

    @property
    def frac_used(self) -> float:
        return self.used / self.capacity


class GlobalHeap:
    """The PGAS: one partition per server + a shared stack region map."""

    def __init__(self, n_servers: int, partition_bytes: int | None = None):
        self.n = n_servers
        self.partitions = [Partition(s) for s in range(n_servers)]
        if partition_bytes is not None:
            for p in self.partitions:
                p.limit = p.base + partition_bytes

    def add_partition(self, partition_bytes: int | None = None) -> Partition:
        """Elastic grow: back a new server with a fresh partition.  The
        global address space already reserves the range (addresses encode
        the partition index), so growing is just mapping it."""
        p = Partition(self.n)
        if partition_bytes is not None:
            p.limit = p.base + partition_bytes
        self.partitions.append(p)
        self.n += 1
        return p

    def partition_of(self, raw: int) -> Partition:
        return self.partitions[A.server_of(raw)]

    def alloc_on(self, server: int, size: int, data: Any) -> int:
        return self.partitions[server].alloc(size, data)

    def get(self, raw: int) -> Obj:
        return self.partition_of(raw).get(raw)

    def free(self, raw: int) -> Obj:
        return self.partition_of(raw).free(raw)

    def contains(self, raw: int) -> bool:
        return self.partition_of(raw).contains(raw)

    def tie_closure(self, raw: int) -> list[int]:
        """Transitive TBox group rooted at ``raw`` (including the root)."""
        out, stack, seen = [], [raw], set()
        while stack:
            a = stack.pop()
            if a in seen:
                continue
            seen.add(a)
            out.append(a)
            stack.extend(self.get(a).ties)
        return out

    def group_bytes(self, raw: int) -> int:
        return sum(self.get(a).size for a in self.tie_closure(raw))
