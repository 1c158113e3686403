"""Distributed mpsc channels (§4.1.2).

Because the heap is globally shared, a message containing Box pointers /
references is valid on any server: the sender pushes the object *as is*
(pointer words, no serialization) and the receiver recovers it by type
conversion (no deserialization).  Cross-server sends cost one two-sided
message of the pointer bytes; same-server sends are queue ops.

This is the mechanism behind the SocialNet result: pass-by-reference RPC
eliminates the serialize/deserialize cycle entirely.

Under ``Cluster(coalesce="auto")`` reference sends are *staged*: the
runtime buffers them per (sender, destination) and rings one wire message
per pair at the quantum settle point — a receiver's first ``recv`` or
``Cluster.close_quanta()`` — the runtime-policy counterpart of the
hand-written ``send_many`` drain.  Values are delivered in original send
order, so program-visible FIFO semantics are unchanged; only the wire
accounting coalesces.  By-value sends (``nbytes`` given) are never staged:
the payload copy is the cost being measured in that baseline.
"""

from __future__ import annotations

from collections import deque
from typing import Any

POINTER_BYTES = 16      # colored global address + extension word


class Channel:
    def __init__(self, cluster, capacity: int = 1 << 16):
        self.cluster = cluster
        self.q: deque = deque()
        self.capacity = capacity
        self.sent = 0
        self.recv_server: int | None = None   # pinned at rx() time
        self._staged: list = []               # [(value, sender th, dst server)]
        chans = getattr(cluster, "channels", None)
        if chans is not None:
            chans.append(self)                # Cluster.close_quanta settles us

    def _auto(self) -> bool:
        return getattr(self.cluster, "coalesce", "manual") == "auto"

    def send(self, th, value: Any, nbytes: int | None = None) -> None:
        """``nbytes`` is the wire size: pointer words for references (the
        DRust fast path), or the full payload for by-value sends."""
        if nbytes is None and self._auto():
            self._staged.append((value, th, self.recv_server))
            self.sent += 1
            return
        sim = self.cluster.sim
        wire = POINTER_BYTES if nbytes is None else nbytes
        if self.recv_server is not None and self.recv_server != th.server:
            sim.rpc(th, self.recv_server, req_bytes=wire, resp_bytes=0)
        else:
            sim.local_access(th)
        self.q.append((value, th.t_us))
        self.sent += 1

    def send_many(self, th, values, nbytes_each: int | None = None) -> None:
        """Doorbell-coalesced send: K messages to the same receiver ride ONE
        wire message carrying K pointer words (or K payloads for by-value),
        amortizing the per-message round trip — the batched counterpart of
        a service handing its drained inbox downstream."""
        sim = self.cluster.sim
        per = POINTER_BYTES if nbytes_each is None else nbytes_each
        if self.recv_server is not None and self.recv_server != th.server:
            sim.rpc(th, self.recv_server, req_bytes=per * len(values),
                    resp_bytes=0)
        else:
            sim.local_access(th)
        for v in values:
            self.q.append((v, th.t_us))
        self.sent += len(values)

    def flush_sends(self, only_tid: int | None = None) -> None:
        """Settle staged sends: one wire message per (sender, destination
        server) pair carrying that pair's pointer words; values enqueue in
        original send order (FIFO preserved).  ``only_tid`` settles a
        single sender (a region exit): that thread's staged sends ring,
        other senders' stay staged — per-sender FIFO is unaffected."""
        if not self._staged:
            return
        sim = self.cluster.sim
        if only_tid is None:
            staged, self._staged = self._staged, []
        else:
            staged = [e for e in self._staged if e[1].tid == only_tid]
            if not staged:
                return
            self._staged = [e for e in self._staged if e[1].tid != only_tid]
        groups: dict[tuple[int, int | None], list] = {}
        for v, th, dst in staged:
            groups.setdefault((th.tid, dst), []).append(th)
        t_of: dict[tuple[int, int | None], float] = {}
        for key, senders in groups.items():
            th, dst = senders[0], key[1]
            if dst is not None and dst != th.server:
                sim.rpc(th, dst, req_bytes=POINTER_BYTES * len(senders),
                        resp_bytes=0)
            else:
                sim.local_access(th)
            t_of[key] = th.t_us
        for v, th, dst in staged:
            self.q.append((v, t_of[(th.tid, dst)]))

    def drop_for_server(self, dead: int) -> int:
        """Recovery quiesce: dispose staged sends orphaned by ``dead`` —
        sends FROM threads on the dead server (the sender died before its
        quantum settled, so the message was never on the wire) and sends
        TO a receiver pinned on the dead server (nobody will drain them).
        If the receiver itself lived on the dead server its queue dies
        with it.  Returns the number of orphaned messages dropped."""
        n = 0
        if self._staged:
            keep = []
            for v, th, dst in self._staged:
                if th.server == dead or dst == dead:
                    n += 1
                else:
                    keep.append((v, th, dst))
            self._staged = keep
        if self.recv_server == dead:
            n += len(self.q)
            self.q.clear()
            self.recv_server = None
        return n

    def recv(self, th) -> Any:
        self.flush_sends()                   # staged sends land before drain
        sim = self.cluster.sim
        self.recv_server = th.server
        sim.local_access(th)
        value, t_sent = self.q.popleft()
        th.t_us = max(th.t_us, t_sent)       # happens-before: msg arrival
        return value

    def __len__(self) -> int:
        return len(self.q) + len(self._staged)
