from repro_torch.serve.engine import (GenerateConfig, GenerateResult,
                                      decode_pool_step, generate,
                                      init_slot_pool, prefill_into_slots,
                                      slot_pool_like)
from repro_torch.serve.paged import (PageAllocator, PagedLayout,
                                     PagePoolExhausted, PrefixCache,
                                     decode_paged_step, paged_kv_bytes,
                                     paged_pool_like, prefill_into_pages)
from repro_torch.serve.scheduler import (ContinuousScheduler, PagedScheduler,
                                         Request, RequestResult,
                                         needs_exact_prefill,
                                         static_batch_serve)

__all__ = ["GenerateConfig", "GenerateResult", "generate", "init_slot_pool",
           "slot_pool_like", "prefill_into_slots", "decode_pool_step",
           "ContinuousScheduler", "PagedScheduler", "PagedLayout",
           "PageAllocator", "PagePoolExhausted", "PrefixCache",
           "paged_pool_like", "prefill_into_pages", "decode_paged_step",
           "paged_kv_bytes", "Request", "RequestResult", "needs_exact_prefill",
           "static_batch_serve"]
