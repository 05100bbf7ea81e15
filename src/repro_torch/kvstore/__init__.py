"""Paged KV cache of the port: page pool, refcounted allocator and paged
attention (decode and chunked prefill), and the page copy between two
pools that the disaggregated roles migrate through."""
from repro_torch.kvstore.alloc import (OutOfPages, PageAllocator,
                                      reclaimable_prefix)
from repro_torch.kvstore.paged_attention import (paged_attention,
                                                 paged_attention_chunk)
from repro_torch.kvstore.pool import (GARBAGE_PAGE, NO_PAGE, PagedKV,
                                      attention_mask, chunk_attention_mask,
                                      copy_pages, dense_kv_bytes_per_token,
                                      init_pool, init_table,
                                      kv_bytes_per_token, update,
                                      update_chunk)

__all__ = ["GARBAGE_PAGE", "NO_PAGE", "OutOfPages", "PageAllocator",
           "PagedKV", "attention_mask", "chunk_attention_mask", "copy_pages",
           "dense_kv_bytes_per_token", "init_pool", "init_table",
           "kv_bytes_per_token", "paged_attention",
           "paged_attention_chunk", "reclaimable_prefix", "update",
           "update_chunk"]
