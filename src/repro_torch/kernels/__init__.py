"""Hand-written CUDA kernels for Hopper (``sm_90a``) in place of the JAX
package's Pallas TPU kernels.

Each kernel has: ``csrc/<name>.cu`` (CUDA C++ with a plain C interface,
built by ``_build`` with ``nvcc`` at first use and loaded with ``ctypes``),
a wrapper in ``<name>.py`` (checks, output allocation, launch counter), a
plain PyTorch version in ``ref.py``, dispatch by device in ``ops.py``, and
its count of work (FLOPs, bytes, the bound on an H100) in ``cost.py``,
which a wrapper handed a fake tensor records instead of launching.

Kernels:
  decode_attention — K1: one-token query vs a long KV cache or a ring
                     (serve hot loop)
  flash_attention  — K2: GQA attention, causal or not, with an optional
                     sliding window (prefill, training), and its backward
                     (``csrc/flash_attention_bwd.cu``)
  moe_gmm          — K3: the per-expert batched matmul of the MoE block,
                     x (E,C,D) @ w (E,D,F) over the capacity buffers
  rwkv_scan        — K4: the chunked WKV6 recurrence of RWKV6, from a state
  rglru_scan       — K5: the RG-LRU linear recurrence h = a h + b
"""

from . import ops, ref

__all__ = ["ops", "ref"]
