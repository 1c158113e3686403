"""Colored global addresses and pointer layout (paper Fig. 4 / Fig. 8).

DRust's pointer is two 64-bit words:

  word 0 (global address): [ 16-bit color | 48-bit global heap address ]
  word 1 (extension):      immutable ref / owner read path -> local copy address
                           mutable ref / owner write path  -> [U bit | owner slot address]

The color is a version number: every write epoch bumps it, so cache lookups
(keyed by the *colored* address) miss after any mutation even when the raw
address is unchanged.  The U ("updated") bit dedups color bumps within one
write epoch (Algorithms 6/8); it is reset whenever an immutable reference is
created from the owner or mutable reference (Appendix B.4).
"""

from __future__ import annotations

COLOR_BITS = 16
ADDR_BITS = 48
COLOR_SHIFT = ADDR_BITS
ADDR_MASK = (1 << ADDR_BITS) - 1
COLOR_MASK = ((1 << COLOR_BITS) - 1) << COLOR_SHIFT
MAX_COLOR = (1 << COLOR_BITS) - 1
U_BIT = 1 << 63
NULL = 0

# PGAS layout: each server backs one heap partition of PART_SIZE bytes.
# Stacks live in a disjoint range, aligned identically on every server so a
# migrated thread keeps its stack addresses (paper Fig. 3).
PART_SIZE = 1 << 34          # 16 GiB per-server heap partition
STACK_BASE = 1 << 46         # stack region, shared layout on all servers
STACK_SIZE = 1 << 23         # 8 MiB per thread stack


def clear_color(g: int) -> int:
    """CLEARCOLOR: raw 48-bit global address."""
    return g & ADDR_MASK


def get_color(g: int) -> int:
    """GETCOLOR: the 16-bit version."""
    return (g & COLOR_MASK) >> COLOR_SHIFT


def append_color(g: int, color: int) -> int:
    """APPENDCOLOR: replace the color bits of ``g`` with ``color``."""
    return (g & ADDR_MASK) | ((color & MAX_COLOR) << COLOR_SHIFT)


def bump_color(g: int) -> tuple[int, bool]:
    """Increment the color; returns (new colored addr, overflowed).

    On overflow the caller must apply the move-on-overflow strategy: relocate
    the object and reset the color to zero (paper §4.1.1).
    """
    c = get_color(g) + 1
    if c > MAX_COLOR:
        return append_color(g, 0), True
    return append_color(g, c), False


def color_updated(ext: int) -> bool:
    """COLORUPDATED: U bit of the extension word."""
    return bool(ext & U_BIT)


def set_u_bit(ext: int) -> int:
    return ext | U_BIT


def clear_u_bit(ext: int) -> int:
    """CLEARUBIT: owner slot address without the U bit."""
    return ext & ~U_BIT


def server_of(addr: int) -> int:
    """Which server's partition a raw (uncolored) heap address belongs to."""
    a = clear_color(addr)
    if a >= STACK_BASE:
        raise ValueError(f"stack address {a:#x} has no home partition")
    return a // PART_SIZE


def partition_range(server: int) -> tuple[int, int]:
    base = server * PART_SIZE
    return base, base + PART_SIZE


def is_stack(addr: int) -> bool:
    return clear_color(addr) >= STACK_BASE
