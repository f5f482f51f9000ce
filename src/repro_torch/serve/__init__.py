"""The embedding serving tier — the read path of the system, in torch.

The counterpart of ``repro.serve``. Training produces sub-models; the
merge folds them into a consensus table; this package serves that table
to clients from the device:

* :mod:`repro_torch.serve.publish` — incremental merge → versioned
  artifact (one atomic :func:`repro_torch.checkpoint.publish_table` per
  fold);
* :mod:`repro_torch.serve.store`   — artifact directory → always-complete
  table on the device, hot-reloadable;
* :mod:`repro_torch.serve.batcher` — asyncio request coalescing +
  semaphore-bounded batch dispatch;
* :mod:`repro_torch.serve.cache`   — hot-row LRU;
* :mod:`repro_torch.serve.server`  — :class:`EmbeddingServer`, tying the
  four together, including on-the-fly ``reconstruct_missing`` for words
  absent from some sub-models;
* :mod:`repro_torch.serve.tcp`     — a JSON-lines TCP front end.
"""

from repro_torch.serve.batcher import CoalescingBatcher, ServeConfig
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.publish import publish_incremental
from repro_torch.serve.server import MERGED, EmbeddingServer
from repro_torch.serve.store import ArtifactStore
from repro_torch.serve.tcp import request_once, start_tcp_server

__all__ = [
    "ArtifactStore",
    "CoalescingBatcher",
    "EmbeddingServer",
    "LRUCache",
    "MERGED",
    "ServeConfig",
    "publish_incremental",
    "request_once",
    "start_tcp_server",
]
