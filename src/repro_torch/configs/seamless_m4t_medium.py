"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder; the speech frontend
(mel + conv codec) is a STUB — input_specs feeds frame embeddings directly."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=12, encoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    frontend_dim=1024,
    source="arXiv:2308.11596 (enc-dec, multimodal; conv frontend stubbed)",
)
