"""Training of the model zoo: the dense, MoE, xlstm and hybrid families
(counterpart of ``repro.train``): train and serving steps, the token pipeline and
checkpoints."""
from repro_torch.train.steps import (  # noqa: F401
    TrainHParams,
    TrainState,
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
