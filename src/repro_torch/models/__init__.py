"""Model zoo in PyTorch.  Ported so far: the dense decoder, the VLM /
audio backbones with stub frontends (GQA/MQA, qk-norm, GeGLU variants),
RWKV6 and the RG-LRU hybrid with its sliding-window ring cache.  MoE raises
``NotImplementedError`` naming the ROADMAP item that brings it."""

from .config import ModelConfig
from .model import decode_step, forward, init_cache, init_params, loss_fn

__all__ = ["ModelConfig", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn"]
