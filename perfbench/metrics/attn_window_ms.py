"""Device ms a step of the windowed attention layers: the program's
``repro_torch/attn_window`` spans (each windowed layer's attention
sublayer, in the forward and in remat's recompute), summed a step."""

from perfbench.metrics._swa import span_ms


def read(window):
    return span_ms(window, "window")
