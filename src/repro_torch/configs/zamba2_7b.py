"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone with SHARED attention+MLP
blocks interleaved (81 blocks = 27 groups x [2 mamba + 1 shared attn]).
Shared attention runs sliding-window so long-context decode state is bounded."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, blocks_per_attn=2,
    attention="sliding", window=4096,
    source="arXiv:2411.15242 (Mamba2 + shared attn blocks)",
)
