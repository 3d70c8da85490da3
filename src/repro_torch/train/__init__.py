"""Training on the port: AdamW, the train step, int8 error feedback
(``repro.train``'s modules)."""
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    warmup_cosine,
)
from repro_torch.train.step import (  # noqa: F401
    TrainConfig,
    TrainState,
    init_train_state,
    make_train_step,
)
