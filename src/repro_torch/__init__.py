"""CoLA: Decentralized Linear Learning, ported to PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``repro_torch.core.cola`` <-> ``repro.core.cola``, ...) and imports nothing
of it. Entry points take ``device=`` and default to ``"cuda"``.

The LM model zoo's dense family serves through ``build_model`` /
``launch.serve.serve`` (configs from ``get_config``).
"""
from repro_torch.core.cola import (ColaConfig, ColaEnv, ColaState,  # noqa: F401
                                   RunResult, build_env, init_state, run_cola,
                                   solve_reference)
from repro_torch.core.problems import PROBLEMS, Problem  # noqa: F401
from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      smoke_variant)
from repro_torch.models.model import ModelApi, build_model  # noqa: F401
