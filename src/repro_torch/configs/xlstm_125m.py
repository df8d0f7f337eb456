"""xLSTM-125M [arXiv:2405.04517]: alternating mLSTM + sLSTM blocks."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="xlstm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304,
    slstm_ratio=2,  # one sLSTM per mLSTM (paired blocks)
    source="arXiv:2405.04517 (sLSTM + mLSTM blocks)",
)
