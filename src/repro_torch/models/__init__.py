"""Model zoo in PyTorch.  Ported so far: the dense decoder and the VLM /
audio backbones with stub frontends (GQA/MQA, qk-norm, GeGLU variants).
MoE, RWKV6 and RG-LRU raise ``NotImplementedError`` naming the ROADMAP item
that brings them."""

from .config import ModelConfig
from .model import decode_step, forward, init_cache, init_params

__all__ = ["ModelConfig", "decode_step", "forward", "init_cache",
           "init_params"]
