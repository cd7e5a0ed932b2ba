from repro_torch.models.model import (decode_step, head_matrix, init_cache,
                                      init_model, init_model_meta, model_apply,
                                      prefill)

__all__ = ["decode_step", "head_matrix", "init_cache", "init_model",
           "init_model_meta", "model_apply", "prefill"]
