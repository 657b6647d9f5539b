from repro_torch.train.steps import (TrainState, batch_shardings,
                                     init_train_state, make_decode_step,
                                     make_prefill_step,
                                     make_train_state_specs, make_train_step,
                                     state_shardings)

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "make_prefill_step", "make_decode_step", "make_train_state_specs",
           "state_shardings", "batch_shardings"]
