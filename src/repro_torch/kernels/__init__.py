"""Hand-written CUDA kernels for Hopper (``sm_90a``) in place of the JAX
package's Pallas TPU kernels.

Each kernel has: ``csrc/<name>.cu`` (CUDA C++ with a plain C interface,
built by ``_build`` with ``nvcc`` at first use and loaded with ``ctypes``),
a wrapper in ``<name>.py`` (checks, output allocation, launch counter), a
plain PyTorch version in ``ref.py``, and dispatch by device in ``ops.py``.

Kernels:
  decode_attention — K1: one-token query vs a long KV cache (serve hot loop)
  flash_attention  — K2: GQA attention forward, causal or not (prefill)

Still to port (see ROADMAP.md): moe_gmm (K3), rwkv_scan (K4),
rglru_scan (K5).
"""

from . import ops, ref

__all__ = ["ops", "ref"]
