"""K1 ``decode_attention`` on the card: the wrapper of
``csrc/decode_attention.cu`` (replaces the Pallas TPU kernel
``src/repro/kernels/decode_attention.py``).

The wrapper checks its inputs and raises on anything the kernel does not
take, plans the split over the cache (``plan``), allocates the output and
the float32 scratch of the splits, launches on the current stream and
counts the launch (one per call; the splits are combined inside it).  It runs only on CUDA tensors: ``ops.decode_attention`` sends CPU
tensors to ``ref.decode_attention`` instead.

A fake tensor (a trace on ``FakeTensorMode``, inside
``cost.card_path()``) gets its outputs allocated and its call recorded in
``cost``, with ``cost.py``'s count of its work; nothing is launched or
counted as a launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, cost
from ._grad import refuse_grad

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 2048             # 8 chunks of 8 dims on each of 32 lanes
THREADS = 128                   # threads per block
TILE = 64                       # keys per split are a multiple of this
BLOCKS = 2 * 132                # about two blocks per SM of the H100
MAX_SPLITS = 256                # the kernel's combine holds this many
TICKETS = 1 + MAX_SPLITS // 8   # counters per (b, kv head, head group)
TC_ROWS = 16                    # heads per block: the rows of an mma tile

launches = 0                    # kernel launches since the last reset
_fn = None
_tickets: dict[torch.device, torch.Tensor] = {}   # zeroed, per device


class Plan(NamedTuple):
    heads_per_block: int
    head_groups: int            # blocks over one kv head's query heads
    keys_per_split: int
    splits: int
    blocks: int


@functools.lru_cache(maxsize=256)
def plan(B: int, H: int, Hkv: int, S: int, hd: int) -> Plan:
    """The split of the launch, from the shapes alone (the lengths stay on
    the device).  A block holds all G = H / Hkv heads of a group up to 16
    (the rows of the bf16 kernel's mma tile; the float32 kernel's lane
    groups hold them too), so the cache is read once per group when G <=
    16, as at every served shape; the keys are split so that the
    launch has about ``BLOCKS`` blocks, each split a multiple of ``TILE``
    keys, with at most ``MAX_SPLITS`` splits."""
    G = H // Hkv
    # above hd 256 the float32 kernel's lanes hold several chunks each and
    # one head per group of 32 lanes
    hpb = min(G, TC_ROWS if hd <= 256 else THREADS // 32)
    head_groups = -(-G // hpb)
    bases = B * Hkv * head_groups
    want = -(-BLOCKS // bases)
    kps = max(TILE, -(-S // (want * TILE)) * TILE,
              -(-S // (MAX_SPLITS * TILE)) * TILE)
    splits = -(-S // kps)
    return Plan(hpb, head_groups, kps, splits, bases * splits)


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("decode_attention").repro_decode_attention
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def check(q, k, v, lengths) -> None:
    """Raise ``RuntimeError`` for an input that would need a gradient
    (``refuse_grad``), ``ValueError`` unless the kernel takes these inputs."""
    refuse_grad("decode_attention", q, k, v)
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,hd), k/v (B,Hkv,S,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want all "
                         "float32 or all bfloat16")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError("lengths must be (B,) int32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit head-dim stride")
    for t in (q, k, v, lengths):
        if not cost.on_card(t) or t.device != q.device:
            raise ValueError("all inputs must be on one CUDA device")


def _ticket_buffer(device, n: int) -> torch.Tensor:
    """The zeroed counters the splits' last blocks find themselves by; every
    launch leaves them zero.  Launches on one device share them, so they
    run on one stream at a time (the serving path's case)."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


def decode_attention(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,Hkv,S,hd) read through their strides (a permuted
    view of a (B,S,Hkv,hd) cache is fine); lengths: (B,) int32 on the same
    device -> (B,H,hd) in q.dtype.  Positions >= lengths[b] are masked."""
    global launches
    check(q, k, v, lengths)
    B, H, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    lengths = lengths.contiguous()
    pl = plan(B, H, Hkv, S, hd)
    bases = B * Hkv * pl.head_groups
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if cost.is_fake(q):                 # a trace: count it, launch nothing;
        # the lengths are not known, so every cached key is counted
        cost.record("decode_attention", upper_bound=True, B=B, H=H,
                    Hkv=Hkv, S=S, hd=hd, dtype=q.dtype)
        return out
    part = torch.empty(bases * pl.splits * pl.heads_per_block * (hd + 2),
                       dtype=torch.float32, device=q.device)
    tickets = _ticket_buffer(q.device, bases * TICKETS)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
                tickets.data_ptr(), B, H, Hkv, S, hd, pl.heads_per_block,
                pl.keys_per_split, pl.splits, strides, stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError_t {rc}")
    launches += 1
    return out
