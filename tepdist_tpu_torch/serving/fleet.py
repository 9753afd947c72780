"""Disaggregated serving fleet: planner-sharded servables and
prefill/decode pools with paged KV handoff (the port of the JAX
package's ``serving/fleet.py``).

Two independent mechanisms:

PLANNER-SHARDED SERVABLES — when a model's weights + KV cache exceed
one device's HBM budget (``verify_servable`` raises ``hbm_overflow``),
``load_fleet_servable`` routes the load through the SAME candidate
enumeration that prices training plans (``parallel/exploration.py``
``explore``): every TP/PP split is priced by the cost model, the
cheapest EXECUTABLE candidate (pipeline, blocked placement, no
intra-stage TP — TP splits a matmul's reduction and breaks bit
identity) is partitioned into contiguous layer-range stages, and each
stage ships to its own worker as a ``StageServable`` over the
scatter-gather Frames path. ``ShardedServable.generate`` then chains
``ExecuteServableSlice`` calls through the stages: exact ``cfg.dtype``
activation bytes cross the wire (bf16 as its uint16 bits), and every
stage runs the op sequence of ``sampling._forward_with_cache`` (fp32
scores and softmax; masked cache positions contribute exact softmax
zeros), so greedy tokens equal single-device ``sample()``'s. If the cost
model's global best is NOT executable as a serving split, the loader
falls back to the best executable candidate in cost order and records it
(counter ``serve_shard_plan_fallback`` + warning).

PREFILL/DECODE DISAGGREGATION — ``FleetRouter`` splits paged replicas
into a PREFILL pool and a DECODE pool (DistServe/Splitwise,
arXiv:2401.09670 / 2311.18677). Prefill replicas run chunked prefill
only (``submit_request(prefill_only=True)`` parks the request in state
"prefilled"); the router then tells a decode replica to ADOPT: the
decode server pulls exactly the live KV pages over a nested
``ExportPages``, installs them into its own ``PagePool``, and resumes
decode from the prefill-picked first token. Only ``pages_for(T,
page_size)`` live pages move, and pages the adopter already holds via
its prefix cache are never re-shipped. ``AdoptPages`` rides the
idempotency token + server dedup cache, so injected faults replay
exactly once. Routing is PREFIX-AFFINE: the first ``page_size``-token
chunk's chained-blake2b key (PrefixCache's chunk-0 key) pins repeat
prefixes to the prefill replica that already holds their pages (counter
``prefix_affinity_hits``).

Telemetry: histograms ``kv_handoff_ms`` (prefilled -> decoding) and
``disagg_ttft_ms`` (submit -> decoding); flight-recorder events
``kv_export``/``kv_adopt`` (the engines') and ``pool_handoff`` stamped
with page counts.

Stages and replicas run on their servicer's device: the card unless the
servicer was made with ``["cpu"]``.
"""

from __future__ import annotations

import hashlib
import itertools
import logging
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.tree import tree_leaves, tree_map
from tepdist_tpu_torch.models import gpt2
from tepdist_tpu_torch.models.gpt2 import GPT2Config, _layer_norm
from tepdist_tpu_torch.models.sampling import _attn_with_cache, _pick
from tepdist_tpu_torch.rpc import retry
from tepdist_tpu_torch.rpc.client import TepdistClient
from tepdist_tpu_torch.serving.client import ServeOverloadError
from tepdist_tpu_torch.serving.engine import TERMINAL
from tepdist_tpu_torch.serving.kv_cache import config_to_spec
from tepdist_tpu_torch.telemetry import flight, metrics

log = logging.getLogger("tepdist.serving.fleet")


# ---------------------------------------------------------------------
# stage partitioning
# ---------------------------------------------------------------------

def stage_ranges(n_layer: int, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous equal layer ranges [lo, hi) — the serving analogue of
    the pipeline planner's blocked placement. Requires an even split
    (the executable-candidate filter guarantees it)."""
    if n_stages < 1 or n_layer % n_stages != 0:
        raise ValueError(f"cannot split {n_layer} layers into "
                         f"{n_stages} equal stages")
    per = n_layer // n_stages
    return [(s * per, (s + 1) * per) for s in range(n_stages)]


def stage_param_names(cfg: GPT2Config, lo: int, hi: int,
                      first: bool, last: bool) -> List[str]:
    """Dotted leaf names a stage needs, in ship order. The FIRST stage
    embeds (wte+wpe); the LAST norms and projects to logits — the tied
    wte rides again for the logits matmul (cheaper than a cross-stage
    fetch per token, and the HBM check prices both copies)."""
    names: List[str] = []
    if first:
        names += ["wte", "wpe"]
    for i in range(lo, hi):
        names += [f"h{i}.{k}" for k in (
            "ln1_g", "ln1_b", "attn_qkv_w", "attn_qkv_b",
            "attn_proj_w", "attn_proj_b", "ln2_g", "ln2_b",
            "mlp_fc_w", "mlp_fc_b", "mlp_proj_w", "mlp_proj_b")]
    if last:
        if not first:
            names.append("wte")
        names += ["ln_f_g", "ln_f_b"]
    return names


def resolve_leaf(params: Dict[str, Any], name: str):
    """Look one dotted leaf name up in a (possibly nested) param dict."""
    node: Any = params
    for part in name.split("."):
        node = node[part]
    return node


def build_stage_params(names: Sequence[str],
                       leaves: Sequence[Any]) -> Dict[str, Any]:
    """Rebuild the nested stage param dict from (names, leaves) — the
    server half of ``stage_param_names``."""
    if len(names) != len(leaves):
        raise ValueError(f"{len(names)} names vs {len(leaves)} leaves")
    out: Dict[str, Any] = {}
    for name, leaf in zip(names, leaves):
        parts = name.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(leaf)
    return out


# ---------------------------------------------------------------------
# one pipeline stage of a sharded servable
# ---------------------------------------------------------------------

def _stage_step_impl(params, inp, ck, cv, start: int, *, cfg: GPT2Config,
                     lo: int, hi: int, first: bool, last: bool):
    """One forward step over this stage's layer range [lo, hi).

    Numerics contract: per layer this is EXACTLY the op sequence of
    ``sampling._forward_with_cache`` — the same token lookup,
    ``_attn_with_cache`` (fp32 scores/softmax), ``_layer_norm``, ``mlp``
    and residual order — so chaining the stages reproduces the
    single-device forward in ``cfg.dtype``. Input is int tokens [1, S]
    into the FIRST stage, hidden activations [1, S, d] into later ones;
    output is fp32 last-position logits [1, vocab] from the LAST stage,
    activations otherwise. ck/cv ([layers, B, H, max_len, hd]) are
    updated in place."""
    if first:
        S = inp.shape[1]
        x = (params["wte"][inp.long()]
             + params["wpe"][start:start + S]).to(cfg.dtype)
    else:
        x = inp.to(cfg.dtype)
    for j, i in enumerate(range(lo, hi)):
        blk = params[f"h{i}"]
        x = x + _attn_with_cache(
            blk, _layer_norm(x, blk["ln1_g"], blk["ln1_b"]),
            ck[j], cv[j], start, cfg)
        x = x + gpt2.mlp(blk, _layer_norm(x, blk["ln2_g"], blk["ln2_b"]))
    if last:
        h = _layer_norm(x[:, -1], params["ln_f_g"], params["ln_f_b"])
        return (h @ params["wte"].T).float()
    return x


class StageServable:
    """One pipeline stage of a sharded servable, driven over
    ``ExecuteServableSlice``. Serves ONE sequential request stream
    (B=1): "prefill" resets the stage KV cache and runs the prompt,
    "decode" extends it one position. Quacks enough like a serving
    engine (stop/drain/stats) that the servicer's lifecycle paths —
    ``close_servables``, Drain — treat it uniformly."""

    def __init__(self, params: Dict[str, Any], cfg: GPT2Config, *,
                 lo: int, hi: int, first: bool, last: bool,
                 max_len: Optional[int] = None, name: str = "stage",
                 device="cuda"):
        self.device = resolve_device(device)
        self.params = tree_map(
            lambda x: torch.as_tensor(x).to(self.device), params)
        self.cfg = cfg
        self.lo, self.hi = int(lo), int(hi)
        self.first, self.last = bool(first), bool(last)
        self.max_len = int(max_len or cfg.n_ctx)
        self.name = name
        shape = (self.hi - self.lo, 1, cfg.n_head, self.max_len,
                 cfg.head_dim)
        self.ck = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.cv = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self._shapes: set = set()
        self._lock = threading.Lock()

    @torch.no_grad()
    def execute(self, op: str, array, pos: int = 0) -> torch.Tensor:
        with self._lock:
            if op == "prefill":
                # New request: forget the previous stream's cache.
                self.ck.zero_()
                self.cv.zero_()
                start = 0
            elif op == "decode":
                start = int(pos)
            else:
                raise ValueError(f"unknown stage op {op!r}")
            arr = torch.as_tensor(array).to(self.device)
            arr = arr.long() if self.first else arr.to(self.cfg.dtype)
            if arr.shape[1] + start > self.max_len:
                raise ValueError(
                    f"stage {self.name}: position {start}+{arr.shape[1]} "
                    f"exceeds max_len {self.max_len}")
            key = (arr.dim(), int(arr.shape[1]))
            if key not in self._shapes:
                # The eager stage compiles nothing; the counter keeps the
                # JAX package's meaning: a new input shape was seen.
                self._shapes.add(key)
                metrics().counter("serve_compiles").inc()
            return _stage_step_impl(
                self.params, arr, self.ck, self.cv, start, cfg=self.cfg,
                lo=self.lo, hi=self.hi, first=self.first, last=self.last)

    # -- engine-shaped lifecycle (servicer close/drain paths) ----------
    def stop(self, timeout: float = 10.0, drain: bool = True) -> None:
        self._shapes.clear()

    def drain(self, wait_ms: float = 0.0) -> List[Dict[str, Any]]:
        return []

    def stats(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": "stage",
                "stage": [self.lo, self.hi],
                "layers": self.hi - self.lo, "first": self.first,
                "last": self.last, "max_len": self.max_len}


# ---------------------------------------------------------------------
# planner-priced sharding
# ---------------------------------------------------------------------

def _stage_executable(c: Dict[str, Any], n_workers: int,
                      n_layer: int) -> bool:
    """Can this explore() candidate run as a serving split? Pipeline
    with blocked placement and NO intra-stage TP (TP splits the matmul
    reduction and breaks greedy bit-identity), at most one stage per
    worker, and an even layer split."""
    if c.get("kind") != "pipeline":
        return False
    s = int(c.get("num_stages", 0))
    return (c.get("placement") == "blocked"
            and int(c.get("intra_tp", 1)) == 1
            and 2 <= s <= n_workers
            and n_layer % s == 0)


def plan_sharded_servable(cfg: GPT2Config, params, n_workers: int, *,
                          batch_rows: int = 4,
                          seq_len: Optional[int] = None
                          ) -> Dict[str, Any]:
    """Price the FULL candidate space with the training planner and
    pick the cheapest candidate executable as a serving split. The
    split is justified by the same cost model that places training,
    and the fallback from a non-executable global best is recorded, not
    hidden. The example batch lies on the params' device."""
    from tepdist_tpu_torch.parallel.exploration import explore
    device = next(iter(tree_leaves(params))).device
    batch = gpt2.fake_batch(cfg, batch_rows, seq_len, seed=0,
                            device=device)
    best = explore(lambda p, t: gpt2.loss_fn(p, t, cfg), params, batch,
                   n_devices=n_workers, include_seq=False,
                   num_micro_batches=1, pipeline_micro_options=(1,),
                   entry_point="serve_shard")
    cands = sorted(best["candidates"], key=lambda c: c["cost"].key())
    exe = [c for c in cands
           if _stage_executable(c, n_workers, cfg.n_layer)]
    if not exe:
        raise RuntimeError(
            f"no executable serving split for n_layer={cfg.n_layer} "
            f"across {n_workers} workers (candidates: "
            f"{[c.get('kind') for c in cands]})")
    chosen = exe[0]
    if chosen is not cands[0]:
        metrics().counter("serve_shard_plan_fallback").inc()
        log.warning(
            "serve shard plan: global best %s not executable as a "
            "serving split; falling back to %s (rank %d of %d)",
            {k: cands[0].get(k) for k in
             ("kind", "num_stages", "intra_tp", "placement")},
            {k: chosen.get(k) for k in
             ("kind", "num_stages", "intra_tp", "placement")},
            cands.index(chosen), len(cands))
    return {"num_stages": int(chosen["num_stages"]),
            "intra_tp": int(chosen.get("intra_tp", 1)),
            "placement": chosen.get("placement"),
            "fallback": chosen is not cands[0],
            "n_candidates": len(cands), "chosen": chosen,
            # Every candidate in cost order and the search's phase
            # seconds, for the planner's records.
            "candidates": cands,
            "explore_phases": (best.get("report") or {}).get("phases", {})}


def load_sharded(clients: Sequence[TepdistClient], params,
                 cfg: GPT2Config, *, name: str = "sharded",
                 max_len: Optional[int] = None,
                 plan: Optional[Dict[str, Any]] = None,
                 batch_rows: int = 4, seq_len: Optional[int] = None
                 ) -> "ShardedServable":
    """Partition the model per the planner's split and install one
    ``StageServable`` per worker. The sharded verify arm
    (``verify_sharded_servable``) gates the WHOLE split client-side
    before any bytes ship; each worker re-verifies just its own stage
    in LoadServable."""
    clients = list(clients)
    if plan is None:
        plan = plan_sharded_servable(cfg, params, len(clients),
                                     batch_rows=batch_rows,
                                     seq_len=seq_len)
    n_stages = int(plan["num_stages"])
    ranges = stage_ranges(cfg.n_layer, n_stages)
    stages = [(lo, hi, s == 0, s == n_stages - 1)
              for s, (lo, hi) in enumerate(ranges)]
    from tepdist_tpu_torch.analysis.plan_verify import (
        verify_enabled, verify_sharded_servable)
    if verify_enabled():
        verify_sharded_servable(cfg, stages=stages,
                                max_len=int(max_len or cfg.n_ctx),
                                where="load_sharded")
    spec = config_to_spec(cfg)
    placements: List[Tuple[TepdistClient, str]] = []
    for s, (lo, hi, first, last) in enumerate(stages):
        names = stage_param_names(cfg, lo, hi, first, last)
        leaves = [resolve_leaf(params, nm) for nm in names]
        c = clients[s]
        sid = c.load_servable(
            spec, leaves, max_len=max_len, name=f"{name}:s{s}",
            stage={"lo": lo, "hi": hi, "first": first, "last": last,
                   "names": names})
        placements.append((c, sid))
    log.info("load_sharded %r: %d stages %s over %d workers%s", name,
             n_stages, ranges, len(clients),
             " (fallback plan)" if plan.get("fallback") else "")
    return ShardedServable(placements, cfg, plan=plan, max_len=max_len)


def load_fleet_servable(clients: Sequence[TepdistClient], params,
                        cfg: GPT2Config, *, name: str = "fleet",
                        max_len: Optional[int] = None, slots: int = 4,
                        page_size: int = 16,
                        n_pages: Optional[int] = None,
                        hbm_budget_bytes: Optional[float] = None,
                        **load_kwargs):
    """Auto-routing load: if the whole model (weights + paged KV pool)
    fits one device's HBM, install replicated via ``ServeClient``;
    on ``hbm_overflow`` route through the planner and shard
    (``load_sharded``). Returns the loaded handle — both shapes
    expose ``generate(prompts, max_new_tokens=...)``."""
    from tepdist_tpu_torch.analysis.plan_verify import (
        PlanVerificationError, verify_servable)
    from tepdist_tpu_torch.serving.kv_cache import default_buckets
    from tepdist_tpu_torch.serving.paged_kv import derive_n_pages
    v_max_len = int(max_len or cfg.n_ctx)
    try:
        verify_servable(
            cfg, slots=slots, max_len=v_max_len,
            buckets=sorted({min(int(b), v_max_len)
                            for b in default_buckets(v_max_len)}),
            kv_mode="paged", page_size=page_size,
            n_pages=derive_n_pages(cfg, page_size=page_size,
                                   max_len=v_max_len, slots=slots,
                                   n_pages=n_pages,
                                   hbm_budget_bytes=hbm_budget_bytes),
            where="load_fleet_servable")
    except PlanVerificationError as e:
        if e.kind != "hbm_overflow":
            raise
        log.warning("load_fleet_servable %r: %s -> planner-sharded "
                    "load over %d workers", name, e, len(clients))
        return load_sharded(clients, params, cfg, name=name,
                            max_len=max_len)
    from tepdist_tpu_torch.serving.client import ServeClient
    sc = ServeClient(clients=list(clients))
    sc.load(params, cfg, slots=slots, max_len=max_len, name=name,
            kv_mode="paged", page_size=page_size, n_pages=n_pages,
            hbm_budget_bytes=hbm_budget_bytes, **load_kwargs)
    return sc


class ShardedServable:
    """Client handle over one ``StageServable`` per worker. Chains
    ``ExecuteServableSlice`` through the stages; greedy output equals
    ``sampling.sample()``'s (exact ``cfg.dtype`` activation bytes on the
    wire, identical per-layer numerics; the non-greedy path draws with a
    host ``torch.Generator`` seeded with ``seed``, as ``sample()`` does
    on the CPU)."""

    def __init__(self, placements: Sequence[Tuple[TepdistClient, str]],
                 cfg: GPT2Config, *, plan: Optional[Dict[str, Any]] = None,
                 max_len: Optional[int] = None):
        self.placements = list(placements)
        self.cfg = cfg
        self.plan = plan
        self.max_len = int(max_len or cfg.n_ctx)

    @property
    def num_stages(self) -> int:
        return len(self.placements)

    def _forward(self, arr, op: str, pos: int):
        h = arr
        for c, sid in self.placements:
            h = c.execute_servable_slice(sid, op, h, pos=pos)
        return h

    def generate_one(self, prompt, *, max_new_tokens: int,
                     greedy: bool = True, temperature: float = 1.0,
                     top_k: int = 0, seed: int = 0) -> np.ndarray:
        """``sample()``'s contract for one request: int32
        [T + max_new_tokens] of prompt + generated tokens."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        T = int(prompt.size)
        if T < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and "
                             "max_new_tokens >= 1")
        if T + max_new_tokens > self.max_len:
            raise ValueError(f"{T}+{max_new_tokens} tokens exceed "
                             f"max_len {self.max_len}")
        gen = (None if greedy
               else torch.Generator().manual_seed(int(seed)))
        logits = self._forward(prompt.reshape(1, -1), "prefill", 0)
        toks: List[int] = []
        for step in range(int(max_new_tokens)):
            t = int(_pick(torch.as_tensor(logits), gen, temperature,
                          top_k, greedy)[0])
            toks.append(t)
            if step + 1 < max_new_tokens:
                logits = self._forward(np.asarray([[t]], np.int32),
                                       "decode", T + step)
        return np.concatenate([prompt, np.asarray(toks, np.int32)])

    def generate(self, prompts: Sequence, *, max_new_tokens,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, seeds: Optional[Sequence[int]] = None
                 ) -> List[np.ndarray]:
        n = len(prompts)
        mnts = (list(max_new_tokens)
                if isinstance(max_new_tokens, (list, tuple))
                else [max_new_tokens] * n)
        return [self.generate_one(
                    p, max_new_tokens=mnts[i], greedy=greedy,
                    temperature=temperature, top_k=top_k,
                    seed=seeds[i] if seeds is not None else 0)
                for i, p in enumerate(prompts)]

    def stats(self) -> List[Dict[str, Any]]:
        return [{"sid": sid, "addr": getattr(c.stub, "address", "?")}
                for c, sid in self.placements]


# ---------------------------------------------------------------------
# prefill/decode disaggregation
# ---------------------------------------------------------------------

class FleetRouter:
    """Routes requests through a PREFILL pool and a DECODE pool of
    paged serving replicas, with page-table-aware KV handoff between
    them. Lifecycle per request:

      submit() -> prefill replica (prefix-affine pick, failover),
                  ``prefill_only=True`` parks it "prefilled"
      handoff() -> decode replica ``AdoptPages`` (pulls live pages from
                  the prefill replica, resumes decode), then the
                  prefill side releases ("handed_off")
      wait()/generate() -> poll the decode placement to terminal

    Handoff failover: ``AdoptPages`` rides the idem token, so retrying
    it on a SURVIVING decode replica after a crash is exactly-once —
    the engine's rid-dedup is the second layer, and a failed adopt
    deletes its engine record so the retry is never dedup-blocked."""

    def __init__(self, clients: Sequence[TepdistClient], *,
                 prefill: int = 1, decode: Optional[int] = None,
                 wire_dtype: Optional[str] = None,
                 prefix_affinity: bool = True):
        clients = list(clients)
        if decode is None:
            decode = len(clients) - int(prefill)
        prefill, decode = int(prefill), int(decode)
        if prefill < 1 or decode < 1 or prefill + decode > len(clients):
            raise ValueError(
                f"need prefill >= 1, decode >= 1, prefill + decode <= "
                f"{len(clients)} clients (got {prefill}:{decode})")
        self.prefill_clients = clients[:prefill]
        self.decode_clients = clients[prefill:prefill + decode]
        self.wire_dtype = wire_dtype
        self.prefix_affinity = bool(prefix_affinity)
        self._prefill: List[Tuple[TepdistClient, str]] = []
        self._decode: List[Tuple[TepdistClient, str]] = []
        self._uid = uuid.uuid4().hex[:8]
        self._rid_seq = itertools.count(1)
        self._rr_p = itertools.count()
        self._rr_d = itertools.count()
        self._affinity: Dict[bytes, int] = {}
        self._pending: Dict[str, Dict[str, Any]] = {}
        self._where: Dict[str, Tuple[TepdistClient, str]] = {}
        self.page_size = 16
        self.handoff_ms: List[float] = []
        self.ttft_ms: List[float] = []

    # -- lifecycle ------------------------------------------------------
    def load(self, params, cfg: GPT2Config, *, slots: int = 4,
             max_len: Optional[int] = None,
             buckets: Optional[Sequence[int]] = None,
             max_queue: int = 64, name: str = "fleet",
             page_size: int = 16, n_pages: Optional[int] = None,
             hbm_budget_bytes: Optional[float] = None,
             prefix_cache: bool = True,
             prefill_chunk: Optional[int] = None) -> List[str]:
        """Install the model on every replica of both pools (paged KV
        is mandatory — the handoff moves pages)."""
        spec = config_to_spec(cfg)
        leaves = list(tree_leaves(params))
        self.page_size = int(page_size)

        def install(c, role, i):
            return (c, c.load_servable(
                spec, leaves, slots=slots, max_len=max_len,
                buckets=buckets, max_queue=max_queue,
                name=f"{name}:{role}{i}", kv_mode="paged",
                page_size=page_size, n_pages=n_pages,
                hbm_budget_bytes=hbm_budget_bytes,
                prefix_cache=prefix_cache,
                prefill_chunk=prefill_chunk))

        self._prefill = [install(c, "p", i)
                         for i, c in enumerate(self.prefill_clients)]
        self._decode = [install(c, "d", i)
                        for i, c in enumerate(self.decode_clients)]
        self._affinity.clear()
        return [sid for _, sid in self._prefill + self._decode]

    def set_epoch(self, epoch: Optional[int]) -> None:
        """Fence every pool client at ``epoch``: once a new master
        claims the fleet and bumps ``master_epoch``, a router left over
        from the deposed one gets ``StaleEpochError`` on its next
        mutating verb — submit, adopt, release — instead of silently
        double-driving a handoff against the new owner's bookkeeping.
        ``None`` disarms (headers stop carrying the epoch)."""
        for c in self.prefill_clients + self.decode_clients:
            c.epoch = epoch

    # -- prefix-affine prefill routing ---------------------------------
    def _affinity_key(self, prompt) -> Optional[bytes]:
        """PrefixCache's chunk-0 chain key (blake2b over the first
        page_size tokens) — equal key means the prefill replica that
        served it before still holds those pages."""
        ps = self.page_size
        p = np.asarray(prompt, np.int32).reshape(-1)
        if p.size < ps:
            return None
        chunk = np.ascontiguousarray(p[:ps], np.int32)
        return hashlib.blake2b(chunk.tobytes(), digest_size=16).digest()

    def submit(self, prompt, *, max_new_tokens: int,
               request_id: Optional[str] = None, greedy: bool = True,
               temperature: float = 1.0, top_k: int = 0, seed: int = 0,
               deadline_ms: Optional[float] = None,
               slo_class: str = "default") -> Dict[str, Any]:
        """Place one request on the prefill pool (prefill-only), prefix
        affinity first, then round-robin with failover past transport
        errors and overload refusals."""
        if not self._prefill:
            raise RuntimeError("load() the fleet first")
        rid = request_id or f"{self._uid}-{next(self._rid_seq)}"
        flight.record(rid, "submit",
                      prompt_len=int(np.asarray(prompt).size),
                      max_new_tokens=int(max_new_tokens), pool="prefill")
        key = self._affinity_key(prompt) if self.prefix_affinity else None
        n = len(self._prefill)
        if key is not None and key in self._affinity:
            i0 = self._affinity[key]
            metrics().counter("prefix_affinity_hits").inc()
            flight.record(rid, "affinity_hit", replica=i0)
            order = [i0] + [i for i in range(n) if i != i0]
        else:
            i0 = next(self._rr_p) % n
            order = [(i0 + k) % n for k in range(n)]
        last: Any = None
        for i in order:
            c, sid = self._prefill[i]
            try:
                out = dict(c.submit_request(
                    sid, rid, prompt, max_new_tokens=max_new_tokens,
                    greedy=greedy, temperature=temperature, top_k=top_k,
                    seed=seed, deadline_ms=deadline_ms,
                    slo_class=slo_class, prefill_only=True))
            except OSError as e:
                last = e
                continue
            if out.get("status") in ("shed", "draining"):
                last = f"prefill {i}: {out}"
                continue
            if key is not None:
                self._affinity[key] = i
            self._pending[rid] = {
                "prompt": np.asarray(prompt, np.int32).reshape(-1),
                "max_new_tokens": int(max_new_tokens),
                "greedy": bool(greedy),
                "temperature": float(temperature), "top_k": int(top_k),
                "seed": int(seed), "deadline_ms": deadline_ms,
                "slo_class": str(slo_class), "p_idx": i,
                "t_submit": time.monotonic()}
            flight.record(rid, "placed", replica=i, pool="prefill",
                          status=out.get("status"))
            out["request_id"] = rid
            return out
        flight.record(rid, "overload", replicas=n, pool="prefill")
        raise ServeOverloadError(
            f"all {n} prefill replicas unavailable or overloaded "
            f"(last: {last})") from (last if isinstance(last,
                                                        BaseException)
                                     else None)

    # -- the handoff ---------------------------------------------------
    def handoff(self, rid: str, timeout_s: float = 60.0
                ) -> Dict[str, Any]:
        """Wait for the request to park "prefilled", then move it to
        the decode pool: AdoptPages on a decode replica (failing over
        past dead/crashed replicas — exactly-once via the idem token +
        engine dedup), then release the prefill side. Stamps
        ``kv_handoff_ms`` and ``disagg_ttft_ms``."""
        spec = self._pending[rid]
        pc, psid = self._prefill[spec["p_idx"]]
        deadline = time.monotonic() + timeout_s
        while True:
            r = pc.poll_result(psid, [rid], wait_ms=100.0)[0]
            st = r.get("status")
            if st == "prefilled":
                break
            if st in TERMINAL + ("unknown",):
                flight.record(rid, "handoff_fail", status=st)
                raise RuntimeError(
                    f"prefill for {rid} ended {st!r}: {r.get('error')}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"request {rid} not prefilled after {timeout_s}s "
                    f"(status {st!r})")
        t0 = time.monotonic()
        nd = len(self._decode)
        j0 = next(self._rr_d) % nd
        out: Optional[Dict[str, Any]] = None
        last: Any = None
        for k in range(nd):
            j = (j0 + k) % nd
            dc, dsid = self._decode[j]
            try:
                out = dict(dc.adopt_pages(
                    dsid, rid, spec["prompt"],
                    source_addr=pc.stub.address, source_sid=psid,
                    max_new_tokens=spec["max_new_tokens"],
                    greedy=spec["greedy"],
                    temperature=spec["temperature"],
                    top_k=spec["top_k"], seed=spec["seed"],
                    deadline_ms=spec["deadline_ms"],
                    slo_class=spec["slo_class"],
                    wire_dtype=self.wire_dtype))
            except retry.StaleEpochError:
                # Deposed master's router: every replica holds the new
                # fence, so failover would only burn the pool. Surface
                # the fence — the new master owns this request now.
                raise
            except (OSError, retry.ServerError) as e:
                # Dead/crashed decode replica: the failed adopt deleted
                # its engine record, so the next replica's attempt is
                # NOT dedup-blocked; if the crash landed after commit,
                # the idem/rid dedup answers "duplicate" instead.
                last = e
                flight.record(rid, "adopt_retry", replica=j,
                              error=repr(e))
                continue
            if out.get("status") in ("adopted", "duplicate"):
                break
            last = f"decode {j}: {out}"
            out = None
        if out is None:
            flight.record(rid, "handoff_fail", replicas=nd)
            raise RuntimeError(
                f"no decode replica adopted {rid} (last: {last})")
        pc.export_pages(psid, rid, release=True)
        now = time.monotonic()
        h_ms = (now - t0) * 1e3
        ttft = (now - spec["t_submit"]) * 1e3
        metrics().histogram("kv_handoff_ms").observe(h_ms)
        metrics().histogram("disagg_ttft_ms").observe(ttft)
        self.handoff_ms.append(h_ms)
        self.ttft_ms.append(ttft)
        flight.record(rid, "pool_handoff", ms=round(h_ms, 3),
                      src=spec["p_idx"], dst=j,
                      pages=out.get("pages"), reused=out.get("reused"))
        self._where[rid] = (dc, dsid)
        del self._pending[rid]
        return out

    # -- results -------------------------------------------------------
    def poll(self, rids: Optional[Sequence[str]] = None,
             wait_ms: float = 0.0) -> Dict[str, Dict[str, Any]]:
        ids = list(rids) if rids is not None else list(self._where)
        by_place: Dict[Tuple[int, str], List[str]] = {}
        for rid in ids:
            c, sid = self._where[rid]
            by_place.setdefault((id(c), sid), []).append(rid)
        out: Dict[str, Dict[str, Any]] = {}
        for (_, sid), group in by_place.items():
            c = self._where[group[0]][0]
            for r in c.poll_result(sid, group, wait_ms=wait_ms):
                out[r["request_id"]] = r
        return out

    def wait(self, rids: Optional[Sequence[str]] = None,
             timeout_s: float = 120.0,
             poll_ms: float = 200.0) -> Dict[str, Dict[str, Any]]:
        deadline = time.monotonic() + timeout_s
        while True:
            results = self.poll(rids, wait_ms=poll_ms)
            if all(r.get("status") in TERMINAL + ("unknown",)
                   for r in results.values()):
                return results
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"disagg requests not terminal after {timeout_s}s: "
                    f"{ {k: v.get('status') for k, v in results.items()} }")

    def generate(self, prompts: Sequence, *, max_new_tokens,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, seeds: Optional[Sequence[int]] = None,
                 timeout_s: float = 120.0) -> List[np.ndarray]:
        """Submit -> handoff -> wait for every prompt; returns
        ``sample()``-layout prompt+generated arrays (the decode side's
        token list INCLUDES the prefill-picked first token)."""
        n = len(prompts)
        mnts = (list(max_new_tokens)
                if isinstance(max_new_tokens, (list, tuple))
                else [max_new_tokens] * n)
        rids = []
        for i, p in enumerate(prompts):
            out = self.submit(
                p, max_new_tokens=mnts[i], greedy=greedy,
                temperature=temperature, top_k=top_k,
                seed=seeds[i] if seeds is not None else 0)
            if out["status"] not in ("queued", "duplicate"):
                raise RuntimeError(f"submit rejected: {out}")
            rids.append(out["request_id"])
        for rid in rids:
            self.handoff(rid, timeout_s=timeout_s)
        results = self.wait(rids, timeout_s=timeout_s)
        out = []
        for i, rid in enumerate(rids):
            r = results[rid]
            if r["status"] != "done":
                raise RuntimeError(f"request {rid} ended "
                                   f"{r['status']}: {r.get('error')}")
            out.append(np.concatenate([
                np.asarray(prompts[i], np.int32).reshape(-1),
                np.asarray(r["tokens"], np.int32)]))
        return out

    def drain_all(self, wait_ms: float = 0.0) -> Dict[str, Any]:
        """Drain both pools (prefill first — nothing new parks while
        decode finishes). A replica that died since load() is skipped
        (``None`` in its slot) — its pages died with it, and the live
        replicas still get the zero-leak drain. Returns the handed-back
        specs per pool."""
        def drain(c, sid):
            try:
                return c.drain_servable(sid, wait_ms=wait_ms)
            except OSError as e:
                log.warning("drain_all: replica %s unreachable (%r)",
                            c.stub.address, e)
                return None

        handed_p = [drain(c, sid) for c, sid in self._prefill]
        handed_d = [drain(c, sid) for c, sid in self._decode]
        return {"prefill": handed_p, "decode": handed_d}

    def dump_trace(self, path: Optional[str] = None) -> Optional[str]:
        from tepdist_tpu_torch.telemetry.export import dump_merged_trace
        return dump_merged_trace(
            self.prefill_clients + self.decode_clients, path,
            name="disagg_trace")
