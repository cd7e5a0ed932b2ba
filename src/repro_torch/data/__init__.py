from repro_torch.data.pipeline import (BOS, EOS, PAD, LMTaskConfig,
                                       MTTaskConfig, MultilingualMT,
                                       SyntheticLM)
from repro_torch.data.prefetch import Prefetcher, stack_batches

__all__ = ["BOS", "EOS", "PAD", "LMTaskConfig", "MTTaskConfig",
           "MultilingualMT", "Prefetcher", "SyntheticLM", "stack_batches"]
