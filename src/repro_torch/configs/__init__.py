from repro_torch.configs.base import (  # noqa: F401
    ALIASES,
    ARCHS,
    InputShape,
    ModelConfig,
    SHAPES,
    get_config,
    smoke_variant,
)
