"""H2O-Danube3-4B [arXiv:2401.16818]: llama+mistral mix with sliding-window attention."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8, head_dim=120,
    d_ff=10240, vocab_size=32000,
    attention="sliding", window=4096,
    source="arXiv:2401.16818 (llama+mistral mix, SWA)",
)
