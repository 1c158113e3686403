"""Device ms a step of the train step's backward: the program's
``repro_torch/backward`` span (``torch.autograd.grad``, remat's recompute
included).  A span's device ms run from a CUDA event recorded on the
stream as it opens to one recorded as it closes, so they hold the
device's idle moments inside it."""

from perfbench.metrics._spans import phase_ms


def read(window):
    return phase_ms(window, "backward")
