"""Unified architecture configuration covering the 10 assigned families.

The port's copy of :mod:`repro.models.config`: the same fields, defaults and
properties (the port imports nothing of the JAX package)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention
    causal: bool = True
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # MLA (DeepSeek-V2)
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_experts: int = 0
    moe_layer_period: int = 1  # MoE on layers where i % period == period-1
    first_k_dense: int = 0  # first K layers always use the dense MLP
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # hybrid interleave (Jamba): attention on layers where
    # i % attn_layer_period == attn_layer_offset; 0 period => per-family default
    attn_layer_period: int = 0
    attn_layer_offset: int = 0
    # modality frontend stub ([vlm]/[audio] — precomputed embeddings input)
    frontend: str = "none"  # none | vision | audio
    n_frontend_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"  # activations
    param_dtype: str = "float32"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' mixer for layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            period = self.attn_layer_period or 8
            return "attn" if i % period == self.attn_layer_offset else "ssm"
        return "attn"

    def layer_has_moe(self, i: int) -> bool:
        if not self.moe_experts:
            return False
        if i < self.first_k_dense:
            return False
        return i % self.moe_layer_period == self.moe_layer_period - 1

    @property
    def block_pattern_period(self) -> int:
        """Length of the periodic layer pattern (scan unit = one period)."""
        p = 1
        if self.family == "hybrid":
            p = self.attn_layer_period or 8
        if self.moe_experts:
            p = _lcm(p, self.moe_layer_period)
        return p

    @property
    def has_decode(self) -> bool:
        return self.causal  # encoder-only models have no decode step

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode is in-family (SSM/hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d = self.d_model
        total = self.vocab_size * d * 2  # embed + untied head
        for i in range(self.n_layers):
            total += 2 * d  # two norms
            if self.layer_kind(i) == "attn":
                if self.use_mla:
                    qd = self.qk_nope_head_dim + self.qk_rope_head_dim
                    q_in = self.q_lora_rank or d
                    if self.q_lora_rank:
                        total += d * self.q_lora_rank
                    total += q_in * self.n_heads * qd
                    total += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    total += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_head_dim + self.v_head_dim
                    )
                    total += self.n_heads * self.v_head_dim * d
                else:
                    hd = self.resolved_head_dim
                    total += d * self.n_heads * hd  # q
                    total += 2 * d * self.n_kv_heads * hd  # k, v
                    total += self.n_heads * hd * d  # o
            else:
                di, ns, hs = self.d_inner, self.ssm_state, self.ssm_heads
                total += d * (2 * di + 2 * ns + hs)  # in_proj (x,z,B,C,dt)
                total += (di + 2 * ns) * self.ssm_conv  # conv
                total += 3 * hs + di  # A_log, D, dt_bias, gated-norm scale
                total += di * d  # out_proj
            if self.layer_has_moe(i):
                e, fd = self.moe_experts, self.moe_d_ff or self.d_ff
                total += d * e  # router
                total += e * 3 * d * fd
                total += self.moe_shared_experts * 3 * d * fd
            elif self.d_ff:
                total += 3 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared experts only)."""
        if not self.moe_experts:
            return self.param_count()
        d = self.d_model
        fd = self.moe_d_ff or self.d_ff
        inactive_experts = self.moe_experts - self.moe_top_k
        n_moe_layers = sum(
            self.layer_has_moe(i) for i in range(self.n_layers)
        )
        return self.param_count() - n_moe_layers * inactive_experts * 3 * d * fd


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)
