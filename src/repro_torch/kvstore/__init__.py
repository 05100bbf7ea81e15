"""Paged KV cache of the port: page pool, allocator and decode attention."""
from repro_torch.kvstore.alloc import OutOfPages, PageAllocator
from repro_torch.kvstore.paged_attention import paged_attention
from repro_torch.kvstore.pool import (GARBAGE_PAGE, NO_PAGE, PagedKV,
                                      attention_mask, init_pool, init_table,
                                      update)

__all__ = ["GARBAGE_PAGE", "NO_PAGE", "OutOfPages", "PageAllocator",
           "PagedKV", "attention_mask", "init_pool", "init_table",
           "paged_attention", "update"]
