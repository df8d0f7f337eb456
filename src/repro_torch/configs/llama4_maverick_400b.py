"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family]:
MoE 128 experts top-1 + shared expert, chunked local attention (iRoPE-style)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_shared_expert=True,
    moe_every=2,  # alternating dense/MoE layers (~400B total, ~17B active)
    attention="chunked_local", window=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (MoE 128e top-1, early fusion)",
)
