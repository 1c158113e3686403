"""Model zoo in PyTorch: the dense decoder, the VLM / audio backbones with
stub frontends (GQA/MQA, qk-norm, GeGLU variants), the MoE, RWKV6 and the
RG-LRU hybrid with its sliding-window ring cache, and the dry-run's batch
specs (``build_batch_spec``)."""

from .config import ModelConfig
from .model import (build_batch_spec, decode_step, forward, init_cache,
                    init_params, loss_fn)

__all__ = ["ModelConfig", "build_batch_spec", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn"]
