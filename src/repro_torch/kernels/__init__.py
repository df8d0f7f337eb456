# Hand-written Hopper kernels (CUDA C++ under csrc/, built by build.py and
# bound with ctypes), each with its plain PyTorch version beside it:
#   * cd_glm — the CoLA local-subproblem coordinate-descent solver
#     (residual and Gram-cached formulations); ops.cd_solve_kernel maps a
#     Problem onto it
#   * flash_attention — GQA attention with position masks, the LM zoo's
#     attention (models.blocks._attention): split-KV + combine kernels at
#     decode, bf16 tensor cores or fp32 CUDA cores otherwise
from repro_torch.kernels.cd_glm import (  # noqa: F401
    LAUNCHES, cd_solve_blocks, cd_solve_blocks_gram)
