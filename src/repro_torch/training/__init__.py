from repro_torch.training.loop import Trainer, same_decision_runs
from repro_torch.training.steps import (chunked_xent, init_train_state,
                                        make_eval_step, make_train_step,
                                        total_loss, xent_loss)

__all__ = ["Trainer", "chunked_xent", "init_train_state", "make_eval_step",
           "make_train_step", "same_decision_runs", "total_loss", "xent_loss"]
