"""InternVL2-26B [arXiv:2404.16821]: InternViT (STUB: patch embeddings in)
+ InternLM2-20B-style language decoder."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    frontend_dim=3200, num_prefix_tokens=256,
    source="arXiv:2404.16821 (InternViT stubbed; InternLM2 backbone)",
)
