"""Device ms a step of the train step's optimizer: the program's
``repro_torch/optimizer`` span (``apply_updates``: the clip, then AdamW
or Adafactor).  A span's device ms run from a CUDA event recorded on the
stream as it opens to one recorded as it closes, so they hold the
device's idle moments inside it."""

from perfbench.metrics._spans import phase_ms


def read(window):
    return phase_ms(window, "optimizer")
