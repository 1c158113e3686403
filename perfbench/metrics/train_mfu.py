"""The whole training step's share of one H100's bf16 peak: the model
FLOPs of the steps in the traced window over its wall time.  The count is
the ``model_flops`` of the cell's reference module
(``reference/<reference>.py``), frozen in benchmark code."""

from perfbench import counts
from perfbench.reference import train as reference


def read(window):
    if not window.steps or window.window_s <= 0:
        return None
    tr = window.traffic
    flops = reference.module(window.reference).model_flops(
        window.model, tr["batch"], tr["seq_len"])
    return 100.0 * flops * window.steps / window.window_s \
        / counts.PEAK_BF16_FLOPS
