"""Slot-based batched KV cache + length-bucketed serving executables: the
port of ``tepdist_tpu/serving/kv_cache.py``.

A FIXED-CAPACITY slot pool that outlives any single request:

  * ``SlotPool`` — host-side allocator over ``n_slots`` cache rows
    (allocate on admission, release on retirement/cancel). The same code
    as the JAX package's.
  * ``ServableModel`` — owns the pooled ``ck``/``cv`` tensors plus the
    executables the continuous-batching scheduler calls:

      - ``prefill(prompt)``: one request, padded to a LENGTH BUCKET.
        Returns the first sampled-token logits and the per-layer k/v
        stacks for the prompt.
      - ``insert(k, v, slot)``: write a prefilled sequence into its slot.
      - ``decode_step(tok, pos)``: ONE token for EVERY slot with per-slot
        write positions — free slots ride along masked.

    The executables are eager PyTorch (the JAX package's run as XLA
    programs outside any Pallas kernel, so the port has no kernel here).
    They write the pool IN PLACE under ``torch.inference_mode()``, which
    each method enters itself (grad mode is thread-local, and the engine
    calls them from its scheduler thread). The shape-keyed executable
    cache is kept with the JAX package's keys, so ``serve_compiles``
    counts the same distinct (model, bucket) executables at their first
    use, and ``adopt_executables`` hands them to a rebuilt engine.

Numerics contract: the per-slot decode computes the same per-row
attention as ``sampling.sample`` (key position <= query position, fp32
scores and softmax, ``_NEG_INF`` masking), so greedy outputs are
token-identical to sequential ``sample()`` calls. Sampling draws from
each request's own ``torch.Generator`` (threefry cannot be matched), so a
request's draws equal a B = 1 ``sample()`` with a generator seeded alike,
whatever shares its batch.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.tree import tree_map
from tepdist_tpu_torch.models import gpt2, sampling
from tepdist_tpu_torch.models.gpt2 import GPT2Config, _layer_norm
from tepdist_tpu_torch.telemetry import metrics

_NEG_INF = sampling._NEG_INF


class KVFreeError(ValueError):
    """Typed double-free / bad-free of a KV-cache resource. Raised by
    ``SlotPool.release`` and mirrored by ``paged_kv.PagePool`` decref —
    a double release would otherwise silently corrupt the free list and
    hand the same cache row to two requests."""


def config_to_spec(cfg: GPT2Config) -> Dict[str, Any]:
    """JSON-able GPT2Config (dtype by its numpy name: ``float32``,
    ``bfloat16``), as the JAX package writes it."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(d["dtype"]).removeprefix("torch.")
    return d


def config_from_spec(spec: Dict[str, Any]) -> GPT2Config:
    d = dict(spec)
    d["dtype"] = getattr(torch, d["dtype"])
    return GPT2Config(**d)


def default_buckets(max_len: int, min_bucket: int = 8) -> List[int]:
    """Power-of-two prompt-length buckets up to ``max_len`` (inclusive).

    Boundary contract (these buckets also pick chunked-prefill shapes):
    ``max_len`` is always the last bucket, even when it is below
    ``min_bucket`` or not a power of two; a prompt exactly at a bucket
    length maps to that bucket (no pad)."""
    if max_len < 1:
        raise ValueError(f"max_len must be positive, got {max_len}")
    if min_bucket < 1:
        raise ValueError(f"min_bucket must be positive, got {min_bucket}")
    out = []
    b = min_bucket
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return sorted(set(out))


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; a length exactly at a bucket gets that
    bucket. Empty bucket lists and non-positive lengths are caller bugs
    and raise instead of surfacing as a confusing max()/pad error."""
    if not buckets:
        raise ValueError("bucket_for: empty bucket list")
    if length < 1:
        raise ValueError(f"bucket_for: length must be positive, "
                         f"got {length}")
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds the largest bucket "
                     f"{max(buckets)}")


class SlotPool:
    """Host-side slot allocator (the cache rows live in ServableModel)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        # LIFO free list: hot slots are reused first.
        self._free = list(range(n_slots - 1, -1, -1))

    def alloc(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def release(self, slot: int) -> None:
        """Return a slot to the pool. A double release (or a slot id the
        pool never owned) raises the typed ``KVFreeError`` rather than
        corrupting the free list — the engine treats it as a bug, never
        retries it."""
        if not 0 <= slot < self.n_slots:
            raise KVFreeError(f"slot {slot} outside pool "
                              f"[0, {self.n_slots})")
        if slot in self._free:
            raise KVFreeError(f"slot {slot} double-released")
        self._free.append(slot)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_slots - len(self._free)


def params_on(params, device: torch.device):
    """The serving weights (the port's GPT-2 tree, ``h{i}`` layout) on
    ``device``."""
    return tree_map(lambda t: t.to(device), params)


def to_device(a, device) -> torch.Tensor:
    """A host int array as an int64 tensor on ``device``. The copy does not
    wait for the device's queue (the array is staged before it returns),
    so the host goes on queueing work while earlier steps run."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
    return t.to(device, non_blocking=True)


def _embed(params, tokens, pos, cfg: GPT2Config):
    """Token + position embeddings. Positions past ``n_ctx`` (the padded
    tail of a chunk bucket) read the last row, as the JAX gather clamps;
    their outputs are masked everywhere."""
    pos = pos.clamp(max=cfg.n_ctx - 1)
    return (params["wte"][tokens] + params["wpe"][pos]).to(cfg.dtype)


def _logits(params, h):
    h = _layer_norm(h, params["ln_f_g"], params["ln_f_b"])
    return (h @ params["wte"].T).float()


# -- model functions (cached per shape by ServableModel) ---------------------

def _prefill_impl(params, tokens, length: int, cfg: GPT2Config):
    """One request: ``tokens`` [1, T_bucket] (zero-padded past ``length``),
    -> (fp32 logits [vocab] at position ``length``-1,
        k/v stacks [n_layer, H, T_bucket, hd]).

    Reuses ``sampling._attn_with_cache`` layer for layer, so the prompt
    k/v and the last real position's hidden state come from the same ops
    as ``sample()``'s prefill; the padded tail is causally masked from
    every real position."""
    T = tokens.shape[1]
    cache = sampling.init_cache(cfg, 1, T, tokens.device)
    x = _embed(params, tokens, torch.arange(T, device=tokens.device), cfg)
    for i in range(cfg.n_layer):
        blk = params[f"h{i}"]
        x = x + sampling._attn_with_cache(
            blk, _layer_norm(x, blk["ln1_g"], blk["ln1_b"]),
            cache["k"][i], cache["v"][i], 0, cfg)
        x = x + gpt2.mlp(blk, _layer_norm(x, blk["ln2_g"], blk["ln2_b"]))
    return (_logits(params, x[0, length - 1]), cache["k"][:, 0],
            cache["v"][:, 0])


def _insert_impl(ck, cv, k, v, slot: int) -> None:
    """Write a prefilled request ([n_layer, H, T_bucket, hd]) into its
    pool slot, in place; positions past the bucket keep whatever the
    previous occupant left (masked until the new occupant writes them)."""
    T = k.shape[2]
    ck[:, slot, :, :T] = k.to(ck.dtype)
    cv[:, slot, :, :T] = v.to(cv.dtype)


def _decode_step_impl(params, tok, pos, ck, cv, cfg: GPT2Config):
    """One decode token for EVERY slot. ``tok``/``pos`` [S]: each slot's
    input token and its write position (free slots ride along with
    pos=0). Each layer writes the slot's k/v at its position before the
    attention reads the row, as the JAX function orders it. -> fp32
    logits [S, vocab]; the pool is updated in place."""
    S = tok.shape[0]
    H, hd = cfg.n_head, cfg.head_dim
    L = ck.shape[3]
    scale = 1.0 / math.sqrt(hd)
    x = _embed(params, tok, pos, cfg)
    rows = torch.arange(S, device=tok.device)
    k_pos = torch.arange(L, device=tok.device)[None, :]
    mask = (k_pos <= pos[:, None])[:, None, :]              # [S, 1, L]
    for i in range(cfg.n_layer):
        blk = params[f"h{i}"]
        h = _layer_norm(x, blk["ln1_g"], blk["ln1_b"])
        qkv = h @ blk["attn_qkv_w"] + blk["attn_qkv_b"]
        q, k, v = qkv.split(cfg.n_embd, dim=-1)
        q = q.reshape(S, H, hd)
        cki, cvi = ck[i], cv[i]                             # [S, H, L, hd]
        cki[rows, :, pos] = k.reshape(S, H, hd).to(ck.dtype)
        cvi[rows, :, pos] = v.reshape(S, H, hd).to(cv.dtype)
        s = torch.einsum("shd,shld->shl", q.float(), cki.float()) * scale
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=s.device))
        p = torch.softmax(s, dim=-1).to(cvi.dtype)
        o = torch.einsum("shl,shld->shd", p, cvi).reshape(S, -1)
        x = x + (o @ blk["attn_proj_w"] + blk["attn_proj_b"])
        x = x + gpt2.mlp(blk, _layer_norm(x, blk["ln2_g"], blk["ln2_b"]))
    return _logits(params, x)


def _pick_row_impl(logits, generator, temperature: float, top_k: int,
                   greedy: bool):
    """Next-token choice for ONE request (``logits`` [vocab]) — the same
    op sequence as ``sampling._pick`` on a B=1 row, so per-request
    sampling matches a B=1 ``sample()`` call with a generator seeded
    alike. -> a 0-d tensor on the logits' device."""
    return sampling._pick(logits[None], generator, temperature, top_k,
                          greedy)[0]


def request_generator(seed: int, device) -> torch.Generator:
    """A sampled request's own random stream, on the logits' device."""
    return torch.Generator(device=device).manual_seed(int(seed))


class _Executables:
    """The shape-keyed executable cache both servables share."""

    def _compiled(self, cache, key, build):
        fn = cache.get(key)
        if fn is None:
            metrics().counter("serve_compiles").inc()
            fn = build()
            cache[key] = fn
        return fn

    def _pick_fn(self, greedy: bool, top_k: int):
        return self._compiled(
            self._pick_exe, (bool(greedy), int(top_k)),
            lambda: functools.partial(_pick_row_impl, top_k=int(top_k),
                                      greedy=bool(greedy)))

    @torch.inference_mode()
    def pick(self, logits_row, generator, temperature: float, top_k: int,
             greedy: bool) -> int:
        """One request's next token, to the host (the first token after a
        prefill)."""
        fn = self._pick_fn(greedy, top_k)
        return int(fn(logits_row, None if greedy else generator,
                      float(temperature)))

    @torch.inference_mode()
    def pick_rows(self, logits, rows: Sequence[int],
                  specs: Sequence[Tuple[Any, float, int, bool]]
                  ) -> List[int]:
        """Next tokens of a decode batch with one host sync: ``rows[i]`` is
        request i's row of ``logits``, ``specs[i]`` its (generator,
        temperature, top_k, greedy). Greedy rows take one argmax over the
        batch; a sampled row draws from its own generator."""
        fns = [self._pick_fn(g, k) for _, _, k, g in specs]
        sel = logits.index_select(0, to_device(list(rows), logits.device))
        picks = sel.argmax(-1)
        for i, (fn, (gen, temp, _, greedy)) in enumerate(zip(fns, specs)):
            if not greedy:
                picks[i] = fn(sel[i], gen, float(temp))
        return picks.cpu().tolist()


class ServableModel(_Executables):
    """A loaded model + its slot pool + its serving executables. The pool
    and the weights live on ``device``: the card unless the caller asks
    for the CPU."""

    def __init__(self, params, cfg: GPT2Config, *, slots: int = 4,
                 max_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 name: str = "servable", device="cuda"):
        self.cfg = cfg
        self.name = name
        self.device = resolve_device(device)
        self.params = params_on(params, self.device)
        self.n_slots = int(slots)
        self.max_len = int(max_len if max_len is not None else cfg.n_ctx)
        if self.max_len > cfg.n_ctx:
            raise ValueError(
                f"max_len={self.max_len} > n_ctx={cfg.n_ctx}")
        self.buckets = sorted({min(int(b), self.max_len)
                               for b in (buckets
                                         or default_buckets(self.max_len))})
        self.pool = SlotPool(self.n_slots)
        shape = (cfg.n_layer, self.n_slots, cfg.n_head, self.max_len,
                 cfg.head_dim)
        self.ck = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        self.cv = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        # Executable caches, keyed per (this model, bucket).
        self._prefill_exe: Dict[int, Any] = {}
        self._insert_exe: Dict[int, Any] = {}
        self._decode_exe = None
        self._pick_exe: Dict[Tuple[bool, int], Any] = {}

    def adopt_executables(self, other: "ServableModel") -> None:
        """Take over a same-shaped model's executables (the supervisor's
        engine rebuild path). Shape mismatch keeps the fresh empty
        caches."""
        if (other.cfg != self.cfg or other.n_slots != self.n_slots
                or other.max_len != self.max_len
                or list(other.buckets) != list(self.buckets)):
            return
        self._prefill_exe = dict(other._prefill_exe)
        self._insert_exe = dict(other._insert_exe)
        self._decode_exe = other._decode_exe
        self._pick_exe = dict(other._pick_exe)

    @torch.inference_mode()
    def prefill(self, prompt: np.ndarray) -> Tuple[Any, Any, Any, int]:
        """-> (fp32 logits [vocab], k, v stacks, bucket). Pads the prompt
        to its length bucket."""
        T = int(prompt.shape[0])
        b = bucket_for(T, self.buckets)
        toks = np.zeros((1, b), np.int64)
        toks[0, :T] = np.asarray(prompt, np.int64)
        fn = self._compiled(
            self._prefill_exe, b,
            lambda: functools.partial(_prefill_impl, cfg=self.cfg))
        logits, k, v = fn(self.params, to_device(toks, self.device), T)
        return logits, k, v, b

    @torch.inference_mode()
    def insert(self, k, v, slot: int) -> None:
        fn = self._compiled(self._insert_exe, int(k.shape[2]),
                            lambda: _insert_impl)
        fn(self.ck, self.cv, k, v, int(slot))

    @torch.inference_mode()
    def decode_step(self, tok: np.ndarray, pos: np.ndarray):
        """-> fp32 logits [n_slots, vocab]; updates the pool in place."""
        if self._decode_exe is None:
            metrics().counter("serve_compiles").inc()
            self._decode_exe = functools.partial(_decode_step_impl,
                                                 cfg=self.cfg)
        return self._decode_exe(
            self.params, to_device(tok, self.device),
            to_device(pos, self.device), self.ck, self.cv)
