"""Paged KV cache of the port: page pool, allocator and paged attention
(decode and chunked prefill)."""
from repro_torch.kvstore.alloc import (OutOfPages, PageAllocator,
                                      reclaimable_prefix)
from repro_torch.kvstore.paged_attention import (paged_attention,
                                                 paged_attention_chunk)
from repro_torch.kvstore.pool import (GARBAGE_PAGE, NO_PAGE, PagedKV,
                                      attention_mask, chunk_attention_mask,
                                      init_pool, init_table, update,
                                      update_chunk)

__all__ = ["GARBAGE_PAGE", "NO_PAGE", "OutOfPages", "PageAllocator",
           "PagedKV", "attention_mask", "chunk_attention_mask", "init_pool",
           "init_table", "paged_attention", "paged_attention_chunk",
           "reclaimable_prefix", "update", "update_chunk"]
