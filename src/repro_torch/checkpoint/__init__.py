from repro_torch.checkpoint.checkpoint import (latest_step, restore_checkpoint,
                                               save_checkpoint)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
