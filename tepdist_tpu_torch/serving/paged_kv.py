"""Block-paged KV-cache subsystem: page pool, prefix cache, paged model —
the port of ``tepdist_tpu/serving/paged_kv.py``.

The allocation unit is a PAGE (``page_size`` tokens, ~16) instead of a
``max_len`` slot:

  * ``PagePool`` — host-side refcounted allocator over one preallocated
    block-paged KV tensor per layer (``[n_layer, n_pages+1, n_head,
    page_size, head_dim]``; physical page 0 is a write-off "trash" page
    that padded batch rows target). Admission RESERVES pages up front so
    an admitted request can never die of page exhaustion mid-decode.
  * ``PrefixCache`` — maps rolling-hash chains of ``page_size``-token
    prompt chunks to the physical pages holding their K/V; a request
    whose prompt shares a cached prefix attaches to those pages and skips
    their prefill. LRU eviction over refcount-1 leaf chains.
  * ``PagedServableModel`` — the paged twin of ``ServableModel``: owns
    the pool tensors plus the page-indexed executables (chunk prefill
    that attends to history through a page table, page-scatter insert,
    page-gather batched decode), each length-bucketed with the JAX
    package's shape keys, so ``serve_compiles`` counts alike.

The host parts are the JAX package's code. The executables are eager
PyTorch with the JAX functions' op sequence (fp32 scores and softmax,
``_NEG_INF`` masking, so padded pages and trash rows contribute exact
zeros), and they write the pool IN PLACE under ``torch.inference_mode()``
where the JAX functions return a new pool: a functional update would copy
the whole pool every step.

Telemetry: gauges ``pages_used``/``pages_free``/``pages_cached``;
counters ``prefix_hits``/``prefix_hit_tokens``/``prefix_evictions``/
``pages_cow`` (plus ``serve_compiles`` shared with the slot path).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.models import gpt2
from tepdist_tpu_torch.models.gpt2 import GPT2Config, _layer_norm
from tepdist_tpu_torch.serving.kv_cache import (_NEG_INF, KVFreeError,
                                                _embed, _Executables,
                                                _logits, bucket_for,
                                                default_buckets, params_on,
                                                to_device)
from tepdist_tpu_torch.telemetry import metrics

TRASH_PAGE = 0          # physical page 0: masked writes land here


class PageError(RuntimeError):
    """Page-pool invariant violation (exhaustion, reservation underflow,
    bad page id). Double-free specifically raises ``KVFreeError`` — the
    same typed error as ``SlotPool.release`` — so callers can share the
    guard."""


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (0 tokens -> 0 pages)."""
    return -(-int(n_tokens) // int(page_size))


def page_bytes(cfg: GPT2Config, page_size: int,
               dtype_bytes: Optional[int] = None) -> int:
    """HBM bytes of ONE logical page across all layers (k + v)."""
    if dtype_bytes is None:
        dtype_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    return (2 * cfg.n_layer * cfg.n_head * int(page_size)
            * cfg.head_dim * dtype_bytes)


def derive_n_pages(cfg: GPT2Config, *, page_size: int, max_len: int,
                   slots: Optional[int] = None,
                   n_pages: Optional[int] = None,
                   hbm_budget_bytes: Optional[float] = None,
                   dtype_bytes: Optional[int] = None) -> int:
    """Pool capacity, in priority order: explicit ``n_pages`` > the HBM
    budget (``hbm_budget_bytes // page_bytes``) > slot-compat
    (``slots * max_len`` tokens, the HBM the slot pool would have
    reserved). Floored so one ``max_len`` request always fits."""
    if n_pages is not None:
        n = int(n_pages)
    elif hbm_budget_bytes is not None:
        n = int(hbm_budget_bytes // page_bytes(cfg, page_size, dtype_bytes))
    else:
        n = pages_for((slots if slots is not None else 4) * max_len,
                      page_size)
    return max(n, pages_for(max_len, page_size), 1)


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, clamped to cap (executable shape
    bucketing for page counts / batch rows: O(log) distinct compiles)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap) if cap else b


@dataclasses.dataclass
class PageTable:
    """Per-request mapping of logical token positions to physical pages:
    token ``t`` lives in ``pages[t // page_size]`` at offset
    ``t % page_size``. The first ``n_shared`` pages are prefix-cache
    attachments (refcounted, never written); ``reserved`` counts pages
    this request may still allocate without failing."""
    pages: List[int] = dataclasses.field(default_factory=list)
    n_shared: int = 0
    reserved: int = 0


class PagePool:
    """Host-side refcounted page allocator (tensors live in
    PagedServableModel). Physical ids run 1..n_pages; 0 is trash."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError(f"need at least one page, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list, low ids first: hot pages are reused first.
        self._free = list(range(self.n_pages, 0, -1))
        self._ref: Dict[int, int] = {}
        self.reserved = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def available(self) -> int:
        """Free pages not spoken for by an admission reservation."""
        return len(self._free) - self.reserved

    def reserve(self, n: int) -> bool:
        if self.available < n:
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int) -> None:
        if n > self.reserved:
            raise PageError(f"unreserve({n}) exceeds reservation "
                            f"{self.reserved}")
        self.reserved -= n

    def alloc(self, n: int = 1, *, reserved: bool = False) -> List[int]:
        """Allocate ``n`` pages at refcount 1. ``reserved=True`` draws
        down an admission reservation (guaranteed by the reserve())
        check); otherwise only un-reserved free pages are eligible."""
        if reserved:
            if self.reserved < n:
                raise PageError(f"alloc({n}) exceeds reservation "
                                f"{self.reserved}")
        elif self.available < n:
            raise PageError(f"page pool exhausted: want {n}, "
                            f"{self.available} available "
                            f"({self.n_free} free, {self.reserved} reserved)")
        if len(self._free) < n:   # pragma: no cover — reserve() invariant
            raise PageError(f"page pool exhausted: want {n}, "
                            f"{len(self._free)} free")
        if reserved:
            self.reserved -= n
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, page: int) -> None:
        if page not in self._ref:
            raise PageError(f"incref of unallocated page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; frees the page at zero (returns True).
        A decref of a free/unknown page is a DOUBLE FREE: typed raise,
        never a silent free-list corruption (mirrors SlotPool.release)."""
        c = self._ref.get(page, 0)
        if c <= 0:
            raise KVFreeError(f"page {page} double-freed (refcount 0)")
        c -= 1
        if c == 0:
            del self._ref[page]
            self._free.append(page)
            return True
        self._ref[page] = c
        return False

    def free_pages(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.decref(p)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def refs_total(self) -> int:
        return sum(self._ref.values())


class PrefixCache:
    """Rolling-hash chain of full prompt pages -> physical page ids.

    Entry ``i`` is keyed by ``blake2b(key[i-1] + tokens[i*ps:(i+1)*ps])``
    — a chained digest over the whole prefix, so equal keys imply equal
    prefixes (128-bit: collisions are a non-concern) and a chain can be
    walked chunk-by-chunk from any prompt. The cache holds ONE refcount
    on each entry's page; eviction is LRU over leaf entries whose page
    nobody else references."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self._entries: "OrderedDict[bytes, _CacheEntry]" = OrderedDict()

    def _keys(self, prompt: np.ndarray) -> List[bytes]:
        ps = self.page_size
        out: List[bytes] = []
        d = b""
        for c in range(len(prompt) // ps):
            chunk = np.ascontiguousarray(prompt[c * ps:(c + 1) * ps],
                                         np.int32)
            d = hashlib.blake2b(d + chunk.tobytes(),
                                digest_size=16).digest()
            out.append(d)
        return out

    def lookup(self, prompt: np.ndarray) -> List[int]:
        """Longest cached page chain covering a prefix of ``prompt``
        (whole pages only). Touches the chain's LRU position; does NOT
        take references — the caller increfs what it attaches."""
        pages: List[int] = []
        for key in self._keys(prompt):
            e = self._entries.get(key)
            if e is None:
                break
            self._entries.move_to_end(key)
            pages.append(e.page)
        return pages

    def insert(self, prompt: np.ndarray, pages: Sequence[int]) -> int:
        """Register the full prompt pages (``pages[i]`` holds tokens
        ``[i*ps, (i+1)*ps)``); each NEW entry takes one refcount. Chunks
        already cached (e.g. the shared prefix this request attached to)
        are skipped. Returns the number of new entries."""
        added = 0
        parent: Optional[bytes] = None
        for key, page in zip(self._keys(prompt), pages):
            e = self._entries.get(key)
            if e is None:
                self.pool.incref(page)
                self._entries[key] = _CacheEntry(page=page, parent=parent)
                if parent is not None:
                    self._entries[parent].children += 1
                added += 1
            self._entries.move_to_end(key)
            parent = key
        return added

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` by dropping LRU chains — only entries
        with no cached children whose page the cache alone references
        (evicting a page a live request shares would corrupt it)."""
        freed = 0
        progress = True
        while freed < n_pages and progress:
            progress = False
            for key in list(self._entries):
                e = self._entries[key]
                if e.children or self.pool.refcount(e.page) != 1:
                    continue
                del self._entries[key]
                if e.parent is not None and e.parent in self._entries:
                    self._entries[e.parent].children -= 1
                self.pool.decref(e.page)
                metrics().counter("prefix_evictions").inc()
                freed += 1
                progress = True
                if freed >= n_pages:
                    break
        return freed

    def clear(self) -> None:
        """Drop every cache reference (drain/shutdown): pages still held
        by live requests survive at their request refcount; the rest
        free immediately."""
        for e in self._entries.values():
            self.pool.decref(e.page)
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


@dataclasses.dataclass
class _CacheEntry:
    page: int
    parent: Optional[bytes]
    children: int = 0




# -- executables (cached per shape bucket) ------------------------------------

def _chunk_prefill_impl(params, tokens, length: int, hist_len: int, ck, cv,
                        hist_tbl, cfg: GPT2Config):
    """One prompt CHUNK at logical positions [hist_len, hist_len+length):
    ``tokens`` [1, Cb] (zero-padded past ``length``), history K/V
    gathered from the pool through ``hist_tbl`` [Pb] (trash-padded
    physical page ids). -> (fp32 logits [vocab] at the chunk's last real
    position, chunk k/v stacks [n_layer, H, Cb, hd]).

    Same op sequence as ``sampling._attn_with_cache`` over the same real
    positions: scores fp32, garbage history slots (j >= hist_len) and
    the padded chunk tail masked to _NEG_INF, softmax over [history,
    chunk] — masked entries contribute exact zeros. Reads the pool only."""
    Cb = tokens.shape[1]
    ps = ck.shape[3]
    Pb = hist_tbl.shape[0]
    Lh = Pb * ps
    H, hd = cfg.n_head, cfg.head_dim
    scale = 1.0 / math.sqrt(hd)
    dev = tokens.device
    x = _embed(params, tokens, hist_len + torch.arange(Cb, device=dev), cfg)
    # History slots are valid iff their logical position < hist_len
    # (causality is then automatic); the chunk itself is causal.
    mask_hist = (torch.arange(Lh, device=dev) < hist_len)[None, None, :]
    qi = torch.arange(Cb, device=dev)
    mask_self = (qi[None, :] <= qi[:, None])[None]            # [1, Cb, Cb]
    neg = torch.full((), _NEG_INF, device=dev)
    ks, vs = [], []
    for i in range(cfg.n_layer):
        blk = params[f"h{i}"]
        h = _layer_norm(x, blk["ln1_g"], blk["ln1_b"])
        qkv = h @ blk["attn_qkv_w"] + blk["attn_qkv_b"]       # [1, Cb, 3d]
        q, k, v = qkv.split(cfg.n_embd, dim=-1)
        q = q.reshape(Cb, H, hd).transpose(0, 1)              # [H, Cb, hd]
        k = k.reshape(Cb, H, hd).transpose(0, 1)
        v = v.reshape(Cb, H, hd).transpose(0, 1)
        hk = ck[i][hist_tbl].transpose(0, 1).reshape(H, Lh, hd)
        hv = cv[i][hist_tbl].transpose(0, 1).reshape(H, Lh, hd)
        s_h = torch.einsum("hqd,hld->hql", q.float(), hk.float()) * scale
        s_h = torch.where(mask_hist, s_h, neg)
        s_c = torch.einsum("hqd,hld->hql", q.float(), k.float()) * scale
        s_c = torch.where(mask_self, s_c, neg)
        p = torch.softmax(torch.cat([s_h, s_c], dim=-1),
                          dim=-1).to(cfg.dtype)
        vall = torch.cat([hv.to(cfg.dtype), v], dim=1)
        o = torch.einsum("hql,hld->hqd", p, vall)
        o = o.transpose(0, 1).reshape(1, Cb, -1)
        x = x + (o @ blk["attn_proj_w"] + blk["attn_proj_b"])
        x = x + gpt2.mlp(blk, _layer_norm(x, blk["ln2_g"], blk["ln2_b"]))
        ks.append(k)
        vs.append(v)
    return (_logits(params, x[0, length - 1]), torch.stack(ks),
            torch.stack(vs))


def _paged_insert_impl(ck, cv, k, v, page_ids) -> None:
    """Scatter a chunk's k/v stacks ([n_layer, H, Cb, hd]) into physical
    pages, in place: the chunk starts page-aligned, so page ``j`` of the
    chunk lands whole at ``page_ids[j]`` (trash-padded past the chunk's
    real pages). A partial last page is written zero-padded."""
    n_layer, H, Cb, hd = k.shape
    ps = ck.shape[3]
    Np = page_ids.shape[0]
    pad = Np * ps - Cb
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    k = k.reshape(n_layer, H, Np, ps, hd).transpose(1, 2)
    v = v.reshape(n_layer, H, Np, ps, hd).transpose(1, 2)
    ck[:, page_ids] = k.to(ck.dtype)
    cv[:, page_ids] = v.to(cv.dtype)


def _paged_decode_impl(params, tok, pos, ck, cv, tbl, cfg: GPT2Config):
    """One decode token per batch ROW: ``tok``/``pos`` [Rb], ``tbl``
    [Rb, Pb] per-row physical page ids (padded rows carry pos=0 and an
    all-trash table — their write lands on the trash page and their
    logits are ignored). Each layer writes each row's k/v at
    (tbl[r, pos//ps], pos%ps) in place, THEN gathers the row's pages and
    attends with the slot decode's mask/dtype sequence. -> fp32 logits
    [Rb, vocab]."""
    Rb, Pb = tbl.shape
    ps = ck.shape[3]
    H, hd = cfg.n_head, cfg.head_dim
    L = Pb * ps
    scale = 1.0 / math.sqrt(hd)
    x = _embed(params, tok, pos, cfg)
    off = pos % ps
    tgt = tbl.gather(1, (pos // ps)[:, None])[:, 0]
    k_pos = torch.arange(L, device=tok.device)[None, :]
    mask = (k_pos <= pos[:, None])[:, None, :]                # [Rb, 1, L]
    neg = torch.full((), _NEG_INF, device=tok.device)
    for i in range(cfg.n_layer):
        blk = params[f"h{i}"]
        h = _layer_norm(x, blk["ln1_g"], blk["ln1_b"])
        qkv = h @ blk["attn_qkv_w"] + blk["attn_qkv_b"]
        q, k, v = qkv.split(cfg.n_embd, dim=-1)
        q = q.reshape(Rb, H, hd)
        cki, cvi = ck[i], cv[i]                    # [n_pages+1, H, ps, hd]
        cki[tgt, :, off] = k.reshape(Rb, H, hd).to(ck.dtype)
        cvi[tgt, :, off] = v.reshape(Rb, H, hd).to(cv.dtype)
        gk = cki[tbl].transpose(1, 2).reshape(Rb, H, L, hd)
        gv = cvi[tbl].transpose(1, 2).reshape(Rb, H, L, hd)
        s = torch.einsum("rhd,rhld->rhl", q.float(), gk.float()) * scale
        s = torch.where(mask, s, neg)
        p = torch.softmax(s, dim=-1).to(cvi.dtype)
        o = torch.einsum("rhl,rhld->rhd", p, gv).reshape(Rb, -1)
        x = x + (o @ blk["attn_proj_w"] + blk["attn_proj_b"])
        x = x + gpt2.mlp(blk, _layer_norm(x, blk["ln2_g"], blk["ln2_b"]))
    return _logits(params, x)


def _copy_page_impl(ck, cv, src: int, dst: int) -> None:
    """Copy-on-write: duplicate physical page ``src`` into ``dst``."""
    ck[:, dst] = ck[:, src]
    cv[:, dst] = cv[:, src]


def _adopt_pages_impl(ck, cv, k, v, page_ids) -> None:
    """Disaggregated handoff: scatter shipped page contents ``k``/``v``
    ([n_layer, n, H, ps, hd]) into local physical pages ``page_ids``."""
    ck[:, page_ids] = k.to(ck.dtype)
    cv[:, page_ids] = v.to(cv.dtype)


class PagedServableModel(_Executables):
    """A loaded model + its page pool, prefix cache, and page-indexed
    serving executables (the paged twin of ServableModel).

    Thread contract: pool/cache/table mutation (attach/extend/release/
    commit/cow) is HOST-SIDE bookkeeping the engine calls under its
    condition variable; the executable calls (prefill_chunk/decode_batch/
    pick) touch no host allocator state and run outside the lock."""

    def __init__(self, params, cfg: GPT2Config, *, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 hbm_budget_bytes: Optional[float] = None,
                 slots: Optional[int] = None,
                 max_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 name: str = "servable", device="cuda"):
        self.cfg = cfg
        self.name = name
        self.device = resolve_device(device)
        self.params = params_on(params, self.device)
        self.page_size = int(page_size)
        self.max_len = int(max_len if max_len is not None else cfg.n_ctx)
        if self.max_len > cfg.n_ctx:
            raise ValueError(f"max_len={self.max_len} > n_ctx={cfg.n_ctx}")
        self.buckets = sorted({min(int(b), self.max_len)
                               for b in (buckets
                                         or default_buckets(self.max_len))})
        self.n_pages = derive_n_pages(
            cfg, page_size=self.page_size, max_len=self.max_len,
            slots=slots, n_pages=n_pages, hbm_budget_bytes=hbm_budget_bytes)
        self.chunk_tokens = int(prefill_chunk if prefill_chunk is not None
                                else 2 * self.page_size)
        if self.chunk_tokens < self.page_size \
                or self.chunk_tokens % self.page_size:
            raise ValueError(
                f"prefill_chunk={self.chunk_tokens} must be a positive "
                f"multiple of page_size={self.page_size}")
        self.pool = PagePool(self.n_pages, self.page_size)
        self.prefix = PrefixCache(self.pool) if prefix_cache else None
        shape = (cfg.n_layer, self.n_pages + 1, cfg.n_head,
                 self.page_size, cfg.head_dim)
        self.ck = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.cv = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self._max_req_pages = pages_for(self.max_len, self.page_size)
        # Executable caches: one entry per distinct shape bucket.
        self._chunk_exe: Dict[Tuple[int, int], Any] = {}
        self._insert_exe: Dict[Tuple[int, int], Any] = {}
        self._decode_exe: Dict[Tuple[int, int], Any] = {}
        self._pick_exe: Dict[Tuple[bool, int], Any] = {}
        self._copy_exe = None
        self._adopt_exe: Dict[int, Any] = {}
        self._update_gauges()

    def adopt_executables(self, other: "PagedServableModel") -> None:
        """Supervisor engine-rebuild path: same-shaped pools share every
        executable."""
        if (other.cfg != self.cfg or other.n_pages != self.n_pages
                or other.page_size != self.page_size
                or other.max_len != self.max_len
                or list(other.buckets) != list(self.buckets)):
            return
        self._chunk_exe = dict(other._chunk_exe)
        self._insert_exe = dict(other._insert_exe)
        self._decode_exe = dict(other._decode_exe)
        self._pick_exe = dict(other._pick_exe)
        self._copy_exe = other._copy_exe
        self._adopt_exe = dict(other._adopt_exe)

    def _update_gauges(self) -> None:
        m = metrics()
        m.gauge("pages_used").set(self.pool.n_used)
        m.gauge("pages_free").set(self.pool.n_free)
        m.gauge("pages_cached").set(len(self.prefix)
                                    if self.prefix is not None else 0)

    # -- admission-side bookkeeping (host state; call under engine lock) -
    def request_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case pages a request occupies: cache writes reach
        position prompt+max_new-2 (the final pick is never written), so
        prompt + max_new - 1 token slots."""
        return pages_for(prompt_len + max_new - 1, self.page_size)

    def attach(self, prompt: np.ndarray, max_new: int
               ) -> Optional[Tuple[PageTable, int]]:
        """Admission: longest prefix-cache hit (whole pages, capped so
        at least the prompt's LAST token is re-prefilled — its logits
        seed the first generated token), then reserve every page the
        request could still need. Returns (table, tokens_covered) or
        None when the pool can't fit it even after LRU eviction."""
        T = int(prompt.shape[0])
        total = self.request_pages(T, max_new)
        shared: List[int] = []
        if self.prefix is not None:
            hit = self.prefix.lookup(prompt)
            h_cap = ((T - 1) // self.page_size)     # pages fully < T
            shared = hit[:h_cap]
        # Pin the hit chain BEFORE eviction runs, so evict()'s leaf-first
        # walk cannot free the very pages being attached.
        for p in shared:
            self.pool.incref(p)
        fresh = total - len(shared)
        if self.pool.available < fresh and self.prefix is not None:
            self.prefix.evict(fresh - self.pool.available)
        if not self.pool.reserve(fresh):
            for p in shared:
                self.pool.decref(p)
            return None
        m = metrics()
        h_tokens = len(shared) * self.page_size
        if shared:
            m.counter("prefix_hits").inc()
            m.counter("prefix_hit_tokens").inc(h_tokens)
        self._update_gauges()
        return (PageTable(pages=list(shared), n_shared=len(shared),
                          reserved=fresh), h_tokens)

    def extend_table(self, table: PageTable, n_tokens: int) -> None:
        """Grow the table to cover ``n_tokens`` positions, drawing from
        the request's admission reservation."""
        need = pages_for(n_tokens, self.page_size) - len(table.pages)
        if need <= 0:
            return
        if table.reserved < need:
            raise PageError(f"table reservation underflow: need {need}, "
                            f"reserved {table.reserved}")
        table.pages.extend(self.pool.alloc(need, reserved=True))
        table.reserved -= need
        self._update_gauges()

    def ensure_writable(self, table: PageTable, pos: int) -> None:
        """Copy-on-write guard before a decode write at ``pos``: if the
        target page is shared (prefix-cache attachment), replace it in
        THIS table with a private copy."""
        idx = pos // self.page_size
        if idx >= len(table.pages):
            return
        src = table.pages[idx]
        if self.pool.refcount(src) <= 1:
            return
        if table.reserved > 0:
            dst = self.pool.alloc(1, reserved=True)[0]
            table.reserved -= 1
        else:
            dst = self.pool.alloc(1)[0]
        if self._copy_exe is None:
            metrics().counter("serve_compiles").inc()
            self._copy_exe = _copy_page_impl
        with torch.inference_mode():
            self._copy_exe(self.ck, self.cv, src, dst)
        table.pages[idx] = dst
        if idx < table.n_shared:
            table.n_shared = idx
        self.pool.decref(src)
        metrics().counter("pages_cow").inc()
        self._update_gauges()

    def commit_prefix(self, prompt: np.ndarray, table: PageTable) -> None:
        """Register the prompt's FULL pages in the prefix cache so later
        requests sharing this prompt prefix skip their prefill."""
        if self.prefix is None:
            return
        full = int(prompt.shape[0]) // self.page_size
        if full:
            self.prefix.insert(np.asarray(prompt[:full * self.page_size],
                                          np.int32), table.pages[:full])
        self._update_gauges()

    def release_table(self, table: PageTable) -> None:
        """Retire a request: one decref per table page (fresh pages free;
        prefix-cache pages fall back to the cache's own reference) and
        return the unused reservation."""
        for p in table.pages:
            self.pool.decref(p)
        table.pages = []
        table.n_shared = 0
        if table.reserved:
            self.pool.unreserve(table.reserved)
            table.reserved = 0
        self._update_gauges()

    # -- disaggregated handoff ------------------------------------------
    @torch.inference_mode()
    def export_pages(self, page_ids: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Host copies of the CONTENTS of physical pages ``page_ids`` for
        the prefill->decode wire: k/v [n_layer, len(ids), H, ps, hd]. A
        pure device read — no allocator state touched."""
        idx = to_device(list(page_ids), self.device)
        return self.ck[:, idx].cpu(), self.cv[:, idx].cpu()

    @torch.inference_mode()
    def adopt_pages_into(self, page_ids: Sequence[int], k, v) -> None:
        """Scatter shipped page contents into local physical pages
        ``page_ids`` (already alloc'd by the caller); cached per page
        count, like the other page-indexed executables."""
        fn = self._compiled(self._adopt_exe, len(page_ids),
                            lambda: _adopt_pages_impl)
        dev = self.device
        fn(self.ck, self.cv, torch.as_tensor(k).to(dev),
           torch.as_tensor(v).to(dev), to_device(list(page_ids), dev))

    # -- executables (no host allocator state; run outside the lock) ----
    @torch.inference_mode()
    def prefill_chunk(self, pages: Sequence[int], prompt: np.ndarray,
                      start: int, end: int):
        """Run the chunk executable for prompt[start:end) (start is
        page-aligned; ``pages`` is a SNAPSHOT of the request's page
        table covering ``end`` tokens) and scatter its k/v into the
        chunk's pages. -> fp32 logits [vocab] at position end-1
        (meaningful on the final chunk)."""
        ps = self.page_size
        C = end - start
        Cb = bucket_for(C, self.buckets)
        n_hist = start // ps
        Pb = _pow2_bucket(max(n_hist, 1), self._max_req_pages)
        tbl = np.zeros(Pb, np.int64)
        tbl[:n_hist] = pages[:n_hist]
        toks = np.zeros((1, Cb), np.int64)
        toks[0, :C] = np.asarray(prompt[start:end], np.int64)
        fn = self._compiled(
            self._chunk_exe, (Cb, Pb),
            lambda: functools.partial(_chunk_prefill_impl, cfg=self.cfg))
        dev = self.device
        logits, k, v = fn(self.params, to_device(toks, dev), C, start,
                          self.ck, self.cv, to_device(tbl, dev))
        chunk_pages = pages[n_hist:pages_for(end, ps)]
        Np = pages_for(Cb, ps)
        ids = np.zeros(Np, np.int64)
        ids[:len(chunk_pages)] = chunk_pages
        ins = self._compiled(self._insert_exe, (Cb, Np),
                             lambda: _paged_insert_impl)
        ins(self.ck, self.cv, k, v, to_device(ids, dev))
        return logits

    @torch.inference_mode()
    def decode_batch(self, rows: Sequence[Tuple[Sequence[int], int, int]]):
        """One decode token for every row ``(pages, last_tok, pos)`` —
        ``pages`` a page-table snapshot covering pos+1 tokens. -> fp32
        logits [Rb, vocab]; row i's logits are rows[i]'s."""
        R = len(rows)
        Rb = _pow2_bucket(R, self.n_pages)
        P = max(len(pg) for pg, _, _ in rows)
        Pb = _pow2_bucket(P, self._max_req_pages)
        tok = np.zeros(Rb, np.int64)
        pos = np.zeros(Rb, np.int64)
        tbl = np.zeros((Rb, Pb), np.int64)
        for i, (pg, tk, p) in enumerate(rows):
            tok[i] = tk
            pos[i] = p
            tbl[i, :len(pg)] = pg
        fn = self._compiled(
            self._decode_exe, (Rb, Pb),
            lambda: functools.partial(_paged_decode_impl, cfg=self.cfg))
        dev = self.device
        return fn(self.params, to_device(tok, dev), to_device(pos, dev),
                  self.ck, self.cv, to_device(tbl, dev))
