from repro_torch.train.optimizer import (  # noqa: F401
    OptConfig, adamw_init, adamw_update,
)
from repro_torch.train.loop import (  # noqa: F401
    TrainState, loss_fn, make_train_step, init_train_state,
)
