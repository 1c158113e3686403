"""Device ms a step of the full attention layers of a model that mixes
kinds: the program's ``repro_torch/attn_full`` spans (each full layer's
attention sublayer, in the forward and in remat's recompute), summed a
step."""

from perfbench.metrics._swa import span_ms


def read(window):
    return span_ms(window, "full")
