"""Unified model configuration for every assigned architecture."""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"            # dense | moe | rwkv | rglru | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    act: str = "silu"                # silu | geglu (gated in both cases)
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # expert hidden dim (0 -> d_ff)
    dense_residual: bool = False     # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25

    # RWKV6
    rwkv_head_dim: int = 64

    # RG-LRU hybrid (RecurrentGemma)
    attn_every: int = 0              # 1 attention layer per `attn_every` layers
    window: int = 0                  # local attention window (0 -> global)
    lru_width: int = 0               # 0 -> d_model

    # modality frontend stubs
    prefix_len: int = 0              # precomputed patch/frame embeddings

    # numerics / execution
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 1024           # kv-block size for the chunked XLA path
    attn_impl: str = "xla"           # this port: "plain" runs the plain PyTorch
                                     # attention on the card too; any other
                                     # value runs the CUDA kernels there
    max_target_len: int = 8192       # serving cache default
    unroll_chunks: bool = False      # rwkv: python loop (flops calibration)
    unroll_experts: bool = False     # moe: python loop (flops calibration)
    # ---- beyond-paper perf knobs (EXPERIMENTS §Perf) ----
    ulysses: bool = False            # all-to-all seq<->head resharding
    chunked_ce: int = 0              # CE loss in vocab-chunks (0 = off)
    decode_shard_s: bool = False     # shard_map decode attn (S stays local)
    moe_a2a: bool = False            # all-to-all token dispatch for EP
    serve_weights_tp_only: bool = False  # serving: no FSDP (no opt state to
                                         # amortize; re-gathering per token
                                         # dominates decode collectives)
    dp_only: bool = False            # pure ZeRO-3: batch over every mesh
                                     # axis, weights FSDP-sharded, no TP/SP

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def e_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def lru_d(self) -> int:
        return self.lru_width or self.d_model

    def smoke(self) -> "ModelConfig":
        """A reduced same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else 3),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            head_dim=32 if self.head_dim else 0,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            moe_d_ff=128 if self.n_experts else 0,
            window=min(self.window, 64) if self.window else 0,
            lru_width=128 if self.lru_width else 0,
            prefix_len=min(self.prefix_len, 8),
            attn_chunk=64,
            max_target_len=128,
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        n = emb + d  # final norm
        for i in range(self.n_layers):
            if self.family == "rwkv":
                # time-mix: r,k,v,g,o projections + decay/lora params
                n += 5 * d * d + 2 * d + 6 * 2 * d * 32
                # channel-mix
                n += 2 * d * self.d_ff + d * d // 8
                n += 2 * d
                continue
            is_attn = self._is_attn_layer(i)
            if is_attn:
                n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            else:  # RG-LRU recurrent block
                dl = self.lru_d
                n += 2 * d * dl + dl * d + 2 * dl + 2 * dl * dl // 8
            if self.n_experts:
                n += d * self.n_experts                      # router
                n += self.n_experts * 3 * d * self.e_ff      # experts
                if self.dense_residual:
                    n += 3 * d * self.d_ff
            else:
                n += 3 * d * self.d_ff
            n += 2 * d                                        # norms
        return n

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        inactive = self.n_layers * (self.n_experts - self.top_k) \
            * 3 * self.d_model * self.e_ff
        return full - inactive

    def _is_attn_layer(self, i: int) -> bool:
        if self.family == "rwkv":
            return False
        if self.attn_every:
            return (i % self.attn_every) == (self.attn_every - 1)
        return True
