"""Continuous-batching inference serving: the port of
``tepdist_tpu/serving`` (engines, their client and the fleet).

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
  * client.py  — ServeClient: drives the serve verbs over any
    TepdistClient transport (``inproc:`` or gRPC), with round-robin
    placement, a per-replica circuit breaker, and failover past
    open/overloaded/draining replicas.
  * fleet.py   — the disaggregated fleet: planner-sharded servables
    (models too big for one device's HBM load as pipeline stages priced
    by parallel/exploration.py, with greedy tokens equal to
    single-device sample()) and FleetRouter's prefill/decode pools with
    page-table-aware KV handoff over ExportPages/AdoptPages.

Everything here runs on the card (``device="cuda"``) unless the caller
passes ``device="cpu"`` (the servicers' device, for the fleet).
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
from tepdist_tpu_torch.serving.client import ServeClient, ServeOverloadError
from tepdist_tpu_torch.serving.fleet import (FleetRouter, ShardedServable,
                                             StageServable,
                                             load_fleet_servable,
                                             load_sharded)

__all__ = [
    "ServableModel", "SlotPool", "KVFreeError", "bucket_for",
    "default_buckets", "PageError", "PagePool", "PageTable",
    "PagedServableModel", "PrefixCache", "derive_n_pages", "pages_for",
    "ServeRequest", "ServingEngine", "TERMINAL", "ServingSupervisor",
    "ServeClient", "ServeOverloadError", "FleetRouter",
    "ShardedServable", "StageServable", "load_fleet_servable",
    "load_sharded",
]
