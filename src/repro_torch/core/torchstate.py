"""Ownership-guided distributed state for PyTorch (the paper's technique as
a first-class framework feature; the counterpart of ``repro.core.jaxstate``).

A training/serving stack is a DSM problem: parameters, optimizer state and
KV pages are mutable objects with one writer (the optimizer step / the
decoding request) and many readers (forward replicas, eval, serving weight
refresh, async checkpoint).  ``OwnedState`` applies DRust's protocol to a
tree of tensors (nested dicts/lists/tuples; numpy leaves work too):

  * the pytree has a **colored logical address** (name, color);
  * the writer takes a *mutable borrow* — exclusive, buffers updated in
    place by the step function — and the color is bumped when the borrow
    drops (one bump per write epoch, the U-bit rule);
  * readers take *immutable borrows* keyed by the colored address.  A reader
    whose cache matches the color does **zero communication**; a stale reader
    refetches.  No invalidation traffic exists anywhere.

``StateCache`` is the per-replica read cache (hashmap H).  ``ReplicaSlot``
is the fault-tolerance hook: write-backs are batched per epoch and flushed
at the borrow drop (ownership-transfer point), exactly §4.2.3.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable

from .ownership import BorrowError


def tree_map(fn: Callable[[Any], Any], tree: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """Apply ``fn`` to every leaf of a dict/list/tuple tree; ``is_leaf``
    stops the walk early at a matching node (like ``jax.tree.map``)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any,
                is_leaf: Callable[[Any], bool] | None = None) -> list:
    out: list = []
    tree_map(out.append, tree, is_leaf)
    return out


@dataclass(frozen=True)
class ColoredAddr:
    """Logical colored address of a distributed pytree."""
    name: str
    color: int

    def bumped(self) -> "ColoredAddr":
        return ColoredAddr(self.name, self.color + 1)


class OwnedState:
    """A distributed pytree under the ownership protocol."""

    _uid = itertools.count()

    def __init__(self, name: str, tree: Any, sharding: Any = None):
        self.addr = ColoredAddr(f"{name}#{next(self._uid)}", 0)
        self._tree = tree
        self.sharding = sharding
        self._live_refs = 0
        self._live_mut = False
        self._u = False                       # U bit: bumped this epoch?
        self.write_epochs = 0
        self.on_epoch: list[Callable[[ColoredAddr, Any], None]] = []

    # ---- immutable borrow -------------------------------------------------
    def borrow(self) -> "StateRef":
        if self._live_mut:
            raise BorrowError(f"{self.addr.name}: read during write epoch")
        self._live_refs += 1
        self._u = False                       # B.4: new & resets U
        return StateRef(self, self.addr)

    # ---- mutable borrow -----------------------------------------------------
    def borrow_mut(self) -> "StateMutRef":
        if self._live_mut or self._live_refs:
            raise BorrowError(f"{self.addr.name}: write while borrows alive")
        self._live_mut = True
        return StateMutRef(self)

    # ---- owner access (Algorithm 7/8 analogue) ------------------------------
    def read(self) -> Any:
        if self._live_mut:
            raise BorrowError(f"{self.addr.name}: owner read in write epoch")
        self._u = False
        return self._tree

    def write(self, tree: Any) -> None:
        with self.borrow_mut() as ref:
            ref.set(tree)

    @property
    def color(self) -> int:
        return self.addr.color


class StateRef:
    """Immutable borrow: a colored read-only view.  Use as a scoped guard
    (``with state.borrow() as tree:``) — same RAII discipline as the DSM
    layer's ``ReadGuard``; use after drop raises ``BorrowError``."""

    def __init__(self, owner: OwnedState, addr: ColoredAddr):
        self.owner = owner
        self.addr = addr
        self._dropped = False

    def deref(self) -> Any:
        if self._dropped:
            raise BorrowError(
                f"{self.addr.name}: payload used outside the guard scope")
        return self.owner._tree

    @property
    def value(self) -> Any:
        return self.deref()

    def drop(self) -> None:
        if not self._dropped:
            self._dropped = True
            self.owner._live_refs -= 1

    def __enter__(self):
        return self.deref()

    def __exit__(self, *exc):
        self.drop()
        return False


class StateMutRef:
    """Exclusive write epoch; color bump + epoch hooks fire on drop.  Use
    as a scoped guard (``with state.borrow_mut() as m:``) — the same
    ``value``/``set``/``update`` slot surface as the DSM ``WriteGuard``;
    an exception inside the scope still drops the borrow, and use after
    drop raises ``BorrowError``."""

    def __init__(self, owner: OwnedState):
        self.owner = owner
        self._dropped = False
        self._accessed = False

    def _check_open(self) -> None:
        if self._dropped:
            raise BorrowError(f"{self.owner.addr.name}: write slot used "
                              "outside the guard scope")

    def deref_mut(self) -> Any:
        self._check_open()
        self._accessed = True
        return self.owner._tree

    @property
    def value(self) -> Any:
        return self.deref_mut()

    def set(self, tree: Any) -> None:
        self._check_open()
        self._accessed = True
        self.owner._tree = tree

    def update(self, fn: Callable[[Any], Any]) -> Any:
        val = fn(self.deref_mut())
        self.set(val)
        return val

    def drop(self) -> None:
        if self._dropped:
            return
        self._dropped = True
        o = self.owner
        o._live_mut = False
        if self._accessed:
            # Every write epoch bumps the color.  (The DSM layer additionally
            # implements the paper's U-bit dedup — see core.ownership — but a
            # train step IS the epoch boundary here: checkpoints and replica
            # refresh key off it.)
            o.addr = o.addr.bumped()          # the color bump = invalidation
            o._u = True
            o.write_epochs += 1
            for hook in o.on_epoch:           # batched write-back flush point
                hook(o.addr, o._tree)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.drop()
        return False


class StateCache:
    """Per-replica read cache (hashmap H): colored addr -> cached tree.

    ``fetch`` returns the cached tree when the color matches (zero comms);
    otherwise calls ``transfer`` (e.g. a device copy / collective pull),
    replaces the entry, and counts the refresh.  There is no invalidation
    path — stale entries simply become unreachable, like the paper's cache.
    """

    def __init__(self, transfer: Callable[[Any], Any] | None = None):
        self.entries: dict[str, tuple[int, Any]] = {}
        self.transfer = transfer or (lambda t: t)
        self.hits = 0
        self.refreshes = 0
        self.bytes_transferred = 0

    def fetch(self, state: OwnedState) -> Any:
        with state.borrow() as tree:
            name, color = state.addr.name, state.addr.color
            hit = self.entries.get(name)
            if hit is not None and hit[0] == color:
                self.hits += 1
                return hit[1]
            copied = self.transfer(tree)
            self.entries[name] = (color, copied)
            self.refreshes += 1
            self.bytes_transferred += _tree_bytes(copied)
            return copied

    def evict_stale(self, live: dict[str, int]) -> int:
        victims = [k for k, (c, _) in self.entries.items()
                   if k not in live or live[k] != c]
        for k in victims:
            del self.entries[k]
        return len(victims)


class ReplicaSlot:
    """§4.2.3 for pytrees: a backup copy refreshed once per write epoch."""

    def __init__(self, state: OwnedState):
        self.state = state
        self.backup: tuple[int, Any] | None = None
        self.flushes = 0
        state.on_epoch.append(self._flush)

    def _flush(self, addr: ColoredAddr, tree: Any) -> None:
        # Batched write-back: one snapshot per epoch, at the visibility
        # point.  Must be a real copy: the live buffers are updated in place
        # by the next step (aliasing them would hand the backup to the
        # optimizer).
        self.backup = (addr.color, tree_map(_copy_leaf, tree))
        self.flushes += 1

    def promote(self) -> Any:
        """Failure of the primary: the backup becomes the state."""
        if self.backup is None:
            raise RuntimeError("no backup to promote")
        color, tree = self.backup
        self.state._tree = tree
        self.state.addr = ColoredAddr(self.state.addr.name, color)
        return tree


def _copy_leaf(leaf: Any) -> Any:
    if hasattr(leaf, "clone"):                 # torch.Tensor
        return leaf.clone()
    if hasattr(leaf, "copy"):                  # numpy array
        return leaf.copy()
    return leaf


def _tree_bytes(tree: Any) -> int:
    total = 0
    for leaf in tree_leaves(tree):
        if hasattr(leaf, "element_size"):      # torch.Tensor
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):          # numpy array
            total += int(leaf.nbytes)
    return total
