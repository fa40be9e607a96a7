"""spring-pages: paged, copy-on-write KV pool with density-aware
admission control (port of ``repro/serving/paging``; the reference's
DESIGN.md §12).

Layers, host side first:

  allocator   free-list frame allocator + per-frame refcounts
  blocktable  (request, block) -> frame mapping, chain-hash prefix
              sharing, copy-on-write forks
  admission   density-aware byte budget (20*d + 1 bits/elem pages)
  scheduler   FCFS admission gated on page feasibility; spill/resume
  store       packed page arrays + the gather/scatter programs
  engine      PagedServingEngine: the serving engine on pages
"""

from repro_torch.serving.paging.admission import AdmissionController
from repro_torch.serving.paging.allocator import PageAllocator, PageError
from repro_torch.serving.paging.blocktable import BlockTable, chain_keys
from repro_torch.serving.paging.engine import PagedServingEngine
from repro_torch.serving.paging.scheduler import PagedScheduler, SpilledRequest
from repro_torch.serving.paging.store import PagedKVStore, prompt_rows

__all__ = [
    "AdmissionController",
    "BlockTable",
    "PageAllocator",
    "PageError",
    "PagedKVStore",
    "PagedScheduler",
    "PagedServingEngine",
    "SpilledRequest",
    "chain_keys",
    "prompt_rows",
]
