"""The paper's four evaluation applications (§7.1), backend-agnostic (the
counterpart of ``repro.apps``).

Each app runs unmodified against the three protocol backends
(drust | gam | grappa) on a simulated cluster, plus a ``plain`` analytic
baseline = the original single-machine program (compute + local accesses,
no DSM instrumentation).  Throughputs are reported in ops/virtual-second,
normalized exactly like the paper's Fig. 5.  GEMM's tiles and DataFrame's
chunks are tensors on ``device`` (``cuda`` unless the caller passes
``device="cpu"``); KV Store and SocialNet carry byte strings and take no
device.
"""

from .common import AppResult, plain_time_us, zipf_keys
from .gemm import run_gemm
from .dataframe import run_dataframe
from .kvstore import run_kvstore
from .socialnet import run_socialnet

APPS = {
    "gemm": run_gemm,
    "dataframe": run_dataframe,
    "kvstore": run_kvstore,
    "socialnet": run_socialnet,
}

__all__ = ["APPS", "AppResult", "plain_time_us", "run_dataframe", "run_gemm",
           "run_kvstore", "run_socialnet", "zipf_keys"]
