"""Public model API: init / forward / cache / decode (the counterpart of
``repro.models.model``; ``loss_fn`` comes with the training slice)."""

from __future__ import annotations

from . import transformer as T
from .transformer import forward_hidden  # noqa: F401  (re-export)

init_params = T.init_params
init_cache = T.init_cache
forward = T.forward
decode_step = T.decode_step
