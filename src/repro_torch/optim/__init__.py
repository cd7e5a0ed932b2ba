from repro_torch.optim.adam import (adam_init, adam_update, global_norm,
                                    schedule)

__all__ = ["adam_init", "adam_update", "global_norm", "schedule"]
