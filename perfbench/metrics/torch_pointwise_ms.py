"""Device ms a step of everything that is neither one of the port's own
kernels nor a matrix product of a library: PyTorch's elementwise,
reduction, copy and fill kernels, and the copies and fills the runtime
makes (the optimizer, the casts, the float32 loss)."""

import re

from perfbench import trace

PORT = re.compile(r"\b(flash_attention_(kernel|tc)|bwd_(dot|dkdv_\w+|dq_\w+)"
                  r"|decode_attention_\w+|moe_gmm_\w+|gmm_bwd_\w+"
                  r"|chunk_state|state_scan|chunk_out|rwkv_\w+|rglru_\w+)\b")
GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|cublas|_mm_|splitKreduce"
                  r"|sm90_|sm80_", re.IGNORECASE)


def read(window):
    if not window.steps or not window.device_ops:
        return None
    ops = [op for op in window.device_ops
           if not PORT.search(op[0]) and not GEMM.search(op[0])]
    return 1e3 * trace.device_s(ops) / window.steps
