"""Continuous-batching inference serving on one device: the port of
``tepdist_tpu/serving`` (single engine).

Layers (bottom-up):

  * kv_cache.py — slot-based batched KV-cache pool + length-bucketed
    prefill/decode executables (the ``kv_mode="slots"`` fallback).
  * paged_kv.py — the DEFAULT KV substrate: block-paged pool
    (refcounted 16-token pages + per-request page tables), a rolling-
    hash prefix cache that lets shared-system-prompt requests skip
    prefill, and page-indexed gather/scatter executables for chunked
    prefill and batched paged decode.
  * engine.py  — request queue, admission control with deadlines, and
    the Orca-style iteration-level batching scheduler (chunked prefill
    interleaves long prompts with decode under kv_mode="paged").
  * supervisor.py — ServingSupervisor: engine lifecycle + request
    journal; on an engine fault it rebuilds the engine and replays
    in-flight requests (greedy ones re-prefilled from prompt+prefix),
    sheds load past a queue watermark, and only fails requests once the
    restart budget is spent.

The JAX package's RPC client (``client.py``) and disaggregated fleet
(``fleet.py``) are not ported yet. Everything here runs on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

from tepdist_tpu_torch.serving.kv_cache import (KVFreeError, ServableModel,
                                                SlotPool, bucket_for,
                                                default_buckets)
from tepdist_tpu_torch.serving.paged_kv import (PageError, PagePool,
                                                PageTable,
                                                PagedServableModel,
                                                PrefixCache, derive_n_pages,
                                                pages_for)
from tepdist_tpu_torch.serving.engine import (TERMINAL, ServeRequest,
                                              ServingEngine)
from tepdist_tpu_torch.serving.supervisor import ServingSupervisor

__all__ = [
    "ServableModel", "SlotPool", "KVFreeError", "bucket_for",
    "default_buckets", "PageError", "PagePool", "PageTable",
    "PagedServableModel", "PrefixCache", "derive_n_pages", "pages_for",
    "ServeRequest", "ServingEngine", "TERMINAL", "ServingSupervisor",
]
