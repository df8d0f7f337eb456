"""Architecture & input-shape configuration system (a copy of the
reference's ``repro.configs.base``, which the port may not import).

Every assigned architecture registers a ``ModelConfig`` via its module in
``repro_torch.configs.<id>``; ``get_config(arch_id)`` resolves it, and
``smoke_variant`` produces the reduced same-family config used in CPU smoke
tests (<= 2 layers, d_model <= 512, <= 4 experts).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | xlstm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # attention variants
    attention: str = "full"        # full | sliding | chunked_local
    window: int = 4096
    qk_norm: bool = False
    rope_theta: float = 1e4
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_shared_expert: bool = False
    moe_every: int = 1             # 2 = alternate dense/MoE layers (llama4)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    blocks_per_attn: int = 0       # hybrid: mamba blocks per shared-attn block
    slstm_ratio: int = 0           # xlstm: 1 sLSTM per this many blocks (0=none)
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stubs (audio frames / vision patches)
    frontend_dim: int = 0          # embedding dim produced by the stub frontend
    num_prefix_tokens: int = 0     # patches per image / frames per utterance
    # numerics
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    remat_policy: str = "full"     # full | dots (checkpoint_dots) | none
    attn_compute_dtype: str = "float32"  # scores/PV einsum operand dtype
    # The reference picks its attention implementation with this field; the
    # port keeps it for parity and ignores it: a CUDA tensor always goes to
    # the Hopper kernel, a CPU tensor to its plain version.
    attn_backend: str = "jnp"      # jnp (chunked scan) | pallas (VMEM tiles)
    scan_chunk: int = 256          # chunk for SSM scans / flash attention
    source: str = ""               # citation for the config

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def supports_decode(self) -> bool:
        return True  # no encoder-only archs in the assigned pool

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k decode is feasible (bounded state)."""
        return (self.family in ("xlstm", "hybrid")
                or self.attention in ("sliding", "chunked_local"))


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCHS = [
    "qwen3_4b",
    "stablelm_12b",
    "xlstm_125m",
    "h2o_danube3_4b",
    "llama4_maverick_400b",
    "dbrx_132b",
    "mistral_large_123b",
    "seamless_m4t_medium",
    "internvl2_26b",
    "zamba2_7b",
]


# Assignment ids -> config module names (hyphens normalize to underscores).
ALIASES = {
    "llama4_maverick_400b_a17b": "llama4_maverick_400b",
    "h2o_danube_3_4b": "h2o_danube3_4b",
}


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_")
    arch = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = min(cfg.num_kv_heads, heads)
    updates = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=d_model // heads,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        window=min(cfg.window, 16),
        dtype="float32",
        param_dtype="float32",
        remat=False,
        scan_chunk=16,
    )
    if cfg.num_experts:
        updates["num_experts"] = min(cfg.num_experts, 4)
        updates["experts_per_token"] = min(cfg.experts_per_token, 2)
    if cfg.encoder_layers:
        updates["encoder_layers"] = 2
    if cfg.blocks_per_attn:
        updates["blocks_per_attn"] = 2
        updates["num_layers"] = 3   # one hybrid group: 2 mamba + 1 shared attn
    if cfg.slstm_ratio:
        updates["num_layers"] = 2   # one mLSTM + one sLSTM
    if cfg.frontend_dim:
        updates["frontend_dim"] = min(cfg.frontend_dim, 128)
        updates["num_prefix_tokens"] = min(cfg.num_prefix_tokens, 8)
    if cfg.ssm_state:
        updates["ssm_state"] = min(cfg.ssm_state, 16)
        updates["ssm_head_dim"] = 32
    return dataclasses.replace(cfg, **updates)
