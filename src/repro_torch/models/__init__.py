from repro_torch.models.model import (decode_step, head_matrix, init_cache,
                                      init_model, model_apply, prefill)

__all__ = ["decode_step", "head_matrix", "init_cache", "init_model",
           "model_apply", "prefill"]
