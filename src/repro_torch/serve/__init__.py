"""The DSM-backed serving plane in PyTorch (the counterpart of
``repro.serve``; see ``docs/serving.md`` for the protocol side)."""

from .engine import Request, ServeEngine, ServeFleet
from .kvcache import Page, PagedKVCache
from .loadgen import (LoadResult, OpenLoopDriver, bursty_trace,
                      poisson_trace, synth_prompts)
from .serve_step import make_prefill, make_serve_step

__all__ = ["LoadResult", "OpenLoopDriver", "Page", "PagedKVCache",
           "Request", "ServeEngine", "ServeFleet", "bursty_trace",
           "make_prefill", "make_serve_step", "poisson_trace",
           "synth_prompts"]
