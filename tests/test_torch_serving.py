"""The port's single-engine serving (tepdist_tpu_torch.serving) held against
the JAX package's (tepdist_tpu.serving) at ``CONFIGS["test"]``, on the CPU.

Both sides get the JAX init's weights (through ``convert.py``) and the
same inputs, made from a seed with numpy:

1. the host logic (slot pool, page pool, prefix cache, buckets, pool
   sizing, config specs): one operation sequence in both packages, equal
   return values, equal errors and equal state after every operation;
2. each executable against its JAX function (jitted, as the JAX package
   runs it): logits and K/V within a relative L2 of 1e-5 (fp32 sums in
   another order), greedy picks equal;
3. one engine schedule (chunked prefill, a prefix hit with copy-on-write,
   a cancel mid-decode, a deadline expiry, a drain) through the JAX engine
   and the port's: equal tokens and statuses, page refcounts and counters;
4. the port's own contracts: paged greedy equals ``sample()`` and slot
   mode; a seeded request equals a B = 1 ``sample()`` with a generator
   seeded alike, whatever shares its batch (the JAX package draws with
   threefry, which the port cannot match); a supervisor crash mid chunked
   prefill delivers every request exactly once with the same tokens;
5. bf16: logits within twice the JAX functions' own bf16-vs-fp32 gap
   (the convention of ``tests/test_torch_gpt2.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepdist_tpu import telemetry as jtelemetry
from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.serving import ServingEngine as JEngine
from tepdist_tpu.serving import kv_cache as jkv
from tepdist_tpu.serving import paged_kv as jpk
from tepdist_tpu_torch import convert
from tepdist_tpu_torch import telemetry as ttelemetry
from tepdist_tpu_torch.models import gpt2, sampling
from tepdist_tpu_torch.runtime import faults
from tepdist_tpu_torch.serving import ServingEngine, ServingSupervisor
from tepdist_tpu_torch.serving import kv_cache as tkv
from tepdist_tpu_torch.serving import paged_kv as tpk

torch.set_num_threads(2)

CFG = gpt2.CONFIGS["test"]
JCFG = jgpt2.CONFIGS["test"]
RL2 = 1e-5


@pytest.fixture(scope="module")
def weights():
    jparams = jax.device_get(jgpt2.init_params(JCFG, jax.random.PRNGKey(0)))
    return jparams, convert.to_torch(jparams, device="cpu")


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


# -- 1. host logic ------------------------------------------------------------

def _call(fn, *args, **kw):
    """A return value, or the error's class name and message (the two
    packages raise their own classes of one name)."""
    try:
        out = fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 — compared, not swallowed
        return ("raise", type(e).__name__, str(e))
    return ("ok", out)


def _slot_ops(kv):
    pool = kv.SlotPool(3)
    out = []
    for op, arg in [("alloc", None), ("alloc", None), ("release", 0),
                    ("release", 0), ("release", 7), ("alloc", None),
                    ("alloc", None), ("alloc", None), ("alloc", None),
                    ("release", 2)]:
        fn = getattr(pool, op)
        out.append(_call(fn) if arg is None else _call(fn, arg))
        out.append((list(pool._free), pool.n_free, pool.n_used))
    return out


def _page_ops(pk):
    pool = pk.PagePool(6, 4)
    out = [_call(pk.PagePool, 0, 4), _call(pk.PagePool, 2, 0)]
    for op, args, kw in [
            ("reserve", (3,), {}), ("alloc", (2,), {"reserved": True}),
            ("alloc", (3,), {}), ("alloc", (1,), {}), ("incref", (1,), {}),
            ("incref", (5,), {}), ("decref", (1,), {}), ("decref", (1,), {}),
            ("decref", (1,), {}), ("free_pages", ([2, 6],), {}),
            ("unreserve", (4,), {}), ("unreserve", (1,), {}),
            ("alloc", (2,), {"reserved": True}), ("reserve", (9,), {}),
            ("refcount", (3,), {}), ("refs_total", (), {})]:
        out.append(_call(getattr(pool, op), *args, **kw))
        out.append((list(pool._free), dict(pool._ref), pool.reserved,
                    pool.available, pool.n_used))
    return out


def _prefix_ops(pk):
    pool = pk.PagePool(10, 4)
    cache = pk.PrefixCache(pool)
    rng = np.random.default_rng(4)
    sys_p = rng.integers(0, 500, 8).astype(np.int32)
    a = np.concatenate([sys_p, rng.integers(0, 500, 5)]).astype(np.int32)
    b = np.concatenate([sys_p, rng.integers(0, 500, 9)]).astype(np.int32)

    def state():
        return ([(k.hex(), e.page, e.parent and e.parent.hex(), e.children)
                 for k, e in cache._entries.items()], dict(pool._ref),
                list(pool._free), len(cache))

    out = []
    pa = pool.alloc(3)
    out += [_call(cache.insert, a, pa), state()]
    for p in pa:
        pool.decref(p)
    out += [_call(cache.lookup, b), state()]
    pb = cache.lookup(b)[:2]
    for p in pb:
        pool.incref(p)
    fresh = pool.alloc(2)
    out += [_call(cache.insert, b, pb + fresh), state()]
    out += [_call(cache.evict, 2), state()]
    for p in pb + fresh:
        pool.decref(p)
    out += [_call(cache.evict, 10), state(), _call(cache.lookup, a)]
    pc = pool.alloc(2)
    out += [_call(cache.insert, a[:8], pc), _call(cache.clear), state()]
    return out


def _bucket_ops(kv, pk, cfg):
    out = []
    for args in [(64,), (64, 8), (1,), (5, 8), (100, 16), (0,), (8, 0)]:
        out.append(_call(kv.default_buckets, *args))
    buckets = kv.default_buckets(64)
    for n in (1, 7, 8, 9, 33, 64, 65, 0):
        out.append(_call(kv.bucket_for, n, buckets))
    out.append(_call(kv.bucket_for, 3, []))
    for n, ps in [(0, 16), (1, 16), (16, 16), (17, 16), (1000, 7)]:
        out.append(_call(pk.pages_for, n, ps))
    for n, cap in [(1, 8), (3, 8), (9, 8), (5, 0), (16, 64)]:
        out.append(_call(pk._pow2_bucket, n, cap))
    out.append(_call(pk.page_bytes, cfg, 16))
    out.append(_call(pk.page_bytes, cfg, 16, 2))
    for kw in [dict(page_size=16, max_len=64), dict(page_size=16,
               max_len=64, slots=2), dict(page_size=8, max_len=64,
               n_pages=3), dict(page_size=16, max_len=64,
               hbm_budget_bytes=1e6), dict(page_size=16, max_len=64,
               hbm_budget_bytes=10.0)]:
        out.append(_call(pk.derive_n_pages, cfg, **kw))
    return out


def _spec_ops(kv, models):
    """Each config's wire spec, and the spec read back into a config and
    written again."""
    out = []
    for name in ("test", "1.5B"):
        spec = kv.config_to_spec(models.CONFIGS[name])
        out += [spec, kv.config_to_spec(kv.config_from_spec(spec))]
    return out


@pytest.mark.parametrize("case", ["slot_pool", "page_pool", "prefix_cache",
                                  "buckets", "config_spec"])
def test_host_logic_matches(case):
    run = {"slot_pool": lambda kv, pk, cfg: _slot_ops(kv),
           "page_pool": lambda kv, pk, cfg: _page_ops(pk),
           "prefix_cache": lambda kv, pk, cfg: _prefix_ops(pk),
           "buckets": _bucket_ops,
           "config_spec": lambda kv, pk, cfg: _spec_ops(
               kv, gpt2 if kv is tkv else jgpt2)}[case]
    assert run(tkv, tpk, CFG) == run(jkv, jpk, JCFG)


# -- 2. executables -----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Side:
    """The configs of one comparison: the port's, the JAX package's, and
    whether random pools are first rounded to bf16 (so that an fp32 run
    sees the bf16 run's values)."""
    cfg: gpt2.GPT2Config = CFG
    jcfg: jgpt2.GPT2Config = JCFG
    round_bf16: bool = False

    def pool(self, rng, shape) -> np.ndarray:
        a = (rng.normal(size=shape) * 0.5).astype(np.float32)
        if self.round_bf16:
            a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        return a

    def j(self, a):
        return jnp.asarray(a, self.jcfg.dtype)

    def t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(self.cfg.dtype)


def _jit(fn, cfg=None):
    """The JAX function as the JAX package runs it: jitted, ``cfg``
    static."""
    return jax.jit(fn if cfg is None else functools.partial(fn, cfg=cfg))


def _ints(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64))


def _case_prefill(jp, tp, rng, sd):
    T, length = 16, 11
    toks = np.zeros((1, T), np.int32)
    toks[0, :length] = rng.integers(0, CFG.vocab_size, length)
    want = _jit(jkv._prefill_impl, sd.jcfg)(jp, jnp.asarray(toks),
                                             jnp.int32(length))
    with torch.inference_mode():
        got = tkv._prefill_impl(tp, _ints(toks), length, sd.cfg)
    return want, got


def _case_insert(jp, tp, rng, sd):
    shape = (CFG.n_layer, 3, CFG.n_head, 32, CFG.head_dim)
    ck, cv = sd.pool(rng, shape), sd.pool(rng, shape)
    k, v = (sd.pool(rng, (CFG.n_layer, CFG.n_head, 16, CFG.head_dim))
            for _ in range(2))
    want = _jit(jkv._insert_impl)(sd.j(ck), sd.j(cv), sd.j(k), sd.j(v),
                                  jnp.int32(1))
    tck, tcv = sd.t(ck), sd.t(cv)
    tkv._insert_impl(tck, tcv, sd.t(k), sd.t(v), 1)
    return want, (tck, tcv)


def _case_decode(jp, tp, rng, sd):
    S, L = 3, 32
    shape = (CFG.n_layer, S, CFG.n_head, L, CFG.head_dim)
    ck, cv = sd.pool(rng, shape), sd.pool(rng, shape)
    tok = rng.integers(0, CFG.vocab_size, S).astype(np.int32)
    pos = np.array([5, 0, 31], np.int32)
    want = _jit(jkv._decode_step_impl, sd.jcfg)(
        jp, jnp.asarray(tok), jnp.asarray(pos), sd.j(ck), sd.j(cv))
    tck, tcv = sd.t(ck), sd.t(cv)
    with torch.inference_mode():
        logits = tkv._decode_step_impl(tp, _ints(tok), _ints(pos), tck, tcv,
                                       sd.cfg)
    return want, (logits, tck, tcv)


def _paged_pool(rng, sd, n_pages=9, ps=8):
    shape = (CFG.n_layer, n_pages + 1, CFG.n_head, ps, CFG.head_dim)
    return sd.pool(rng, shape), sd.pool(rng, shape)


def _case_chunk_prefill(jp, tp, rng, sd):
    ck, cv = _paged_pool(rng, sd)
    Cb, length, hist_len = 16, 13, 24
    toks = np.zeros((1, Cb), np.int32)
    toks[0, :length] = rng.integers(0, CFG.vocab_size, length)
    tbl = np.array([4, 2, 7, 0], np.int32)          # 3 pages + trash pad
    want = _jit(jpk._chunk_prefill_impl, sd.jcfg)(
        jp, jnp.asarray(toks), jnp.int32(length), jnp.int32(hist_len),
        sd.j(ck), sd.j(cv), jnp.asarray(tbl))
    with torch.inference_mode():
        got = tpk._chunk_prefill_impl(tp, _ints(toks), length, hist_len,
                                      sd.t(ck), sd.t(cv), _ints(tbl),
                                      sd.cfg)
    return want, got


def _case_paged_insert(jp, tp, rng, sd):
    ck, cv = _paged_pool(rng, sd)
    k, v = (sd.pool(rng, (CFG.n_layer, CFG.n_head, 12, CFG.head_dim))
            for _ in range(2))
    ids = np.array([3, 8], np.int32)
    want = _jit(jpk._paged_insert_impl)(sd.j(ck), sd.j(cv), sd.j(k),
                                        sd.j(v), jnp.asarray(ids))
    tck, tcv = sd.t(ck), sd.t(cv)
    tpk._paged_insert_impl(tck, tcv, sd.t(k), sd.t(v), _ints(ids))
    return want, (tck, tcv)


def _case_paged_decode(jp, tp, rng, sd):
    ck, cv = _paged_pool(rng, sd)
    tok = np.array([5, 17, 0, 0], np.int32)
    pos = np.array([9, 23, 0, 0], np.int32)         # two padded rows
    tbl = np.array([[1, 5, 0, 0], [2, 3, 6, 0], [0] * 4, [0] * 4], np.int32)
    want = _jit(jpk._paged_decode_impl, sd.jcfg)(
        jp, jnp.asarray(tok), jnp.asarray(pos), sd.j(ck), sd.j(cv),
        jnp.asarray(tbl))
    tck, tcv = sd.t(ck), sd.t(cv)
    with torch.inference_mode():
        logits = tpk._paged_decode_impl(tp, _ints(tok), _ints(pos), tck,
                                        tcv, _ints(tbl), sd.cfg)
    # The padded rows write the trash page 0: only the real rows' logits
    # and the real pages count.
    want = (want[0][:2], want[1][:, 1:], want[2][:, 1:])
    return want, (logits[:2], tck[:, 1:], tcv[:, 1:])


def _case_copy_page(jp, tp, rng, sd):
    ck, cv = _paged_pool(rng, sd)
    want = _jit(jpk._copy_page_impl)(sd.j(ck), sd.j(cv), jnp.int32(4),
                                     jnp.int32(7))
    tck, tcv = sd.t(ck), sd.t(cv)
    tpk._copy_page_impl(tck, tcv, 4, 7)
    return want, (tck, tcv)


def _case_adopt_pages(jp, tp, rng, sd):
    ck, cv = _paged_pool(rng, sd)
    k, v = (sd.pool(rng, (CFG.n_layer, 2, CFG.n_head, 8, CFG.head_dim))
            for _ in range(2))
    ids = np.array([6, 1], np.int32)
    want = _jit(jpk._adopt_pages_impl)(sd.j(ck), sd.j(cv), sd.j(k),
                                       sd.j(v), jnp.asarray(ids))
    tck, tcv = sd.t(ck), sd.t(cv)
    tpk._adopt_pages_impl(tck, tcv, sd.t(k), sd.t(v), _ints(ids))
    return want, (tck, tcv)


EXECUTABLES = {
    "prefill": _case_prefill, "insert": _case_insert,
    "decode": _case_decode, "chunk_prefill": _case_chunk_prefill,
    "paged_insert": _case_paged_insert, "paged_decode": _case_paged_decode,
    "copy_page": _case_copy_page, "adopt_pages": _case_adopt_pages,
}


@pytest.mark.parametrize("name", list(EXECUTABLES))
def test_executable_matches_jax(weights, name):
    jp, tp = weights
    want, got = EXECUTABLES[name](jp, tp, np.random.default_rng(9), Side())
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert _rel_l2(_np(g), _np(w)) <= RL2, name
    if name in ("prefill", "decode", "chunk_prefill", "paged_decode"):
        np.testing.assert_array_equal(_np(got[0]).argmax(-1),
                                      _np(want[0]).argmax(-1))


# -- 3. one engine schedule in both packages ----------------------------------

COUNTERS = ("serve_compiles", "prefix_hits", "prefix_hit_tokens",
            "serve_prefill_tokens", "serve_decode_steps", "prefill_chunks",
            "prefix_evictions", "pages_cow", "serve_requests_cancelled",
            "serve_requests_expired", "serve_requests_completed",
            "drain_handoffs", "serve_tokens")


def _schedule(engine, metrics):
    """Chunked prefill (16-token chunks over 8-token pages), a prefix hit
    forced through copy-on-write, a cancel after 3 tokens, a 0 ms
    deadline, and a drain that hands a queued request back."""
    rng = np.random.default_rng(12)
    vocab = CFG.vocab_size
    system = rng.integers(0, vocab, 24)
    prompts = {
        "sys0": np.concatenate([system, rng.integers(0, vocab, 6)]),
        "long": rng.integers(0, vocab, 40),
        "c": rng.integers(0, vocab, 10),
        "late": rng.integers(0, vocab, 5),
        "sys1": np.concatenate([system, rng.integers(0, vocab, 8)]),
        "q": rng.integers(0, vocab, 7),
    }
    new = {"sys0": 4, "long": 6, "c": 10, "late": 2, "sys1": 5, "q": 3}
    before = dict(metrics().snapshot()["counters"])

    def submit(rid, **kw):
        return engine.submit(rid, prompts[rid].astype(np.int32),
                             max_new_tokens=new[rid], **kw)["status"]

    statuses = [submit("sys0"), submit("long"), submit("c"),
                submit("late", deadline_ms=0.0)]
    cancelled = cow = False
    for _ in range(200):
        if not engine._has_work():
            break
        engine.step()
        res = {r["request_id"]: r for r in engine.poll()}
        if not cancelled and res["c"]["n_tokens"] >= 3:
            cancelled = engine.cancel("c")
        if res["sys0"]["status"] == "done" and "sys1" not in res:
            statuses.append(submit("sys1"))
        if not cow and res.get("sys1", {}).get("status") == "active":
            table = engine._reqs["sys1"].table
            assert table.n_shared == 3
            engine.model.ensure_writable(table, 0)
            cow = True
    refs = dict(engine.model.pool._ref)
    statuses.append(submit("q"))
    handed = [h["request_id"] for h in engine.drain(wait_ms=0)]
    after = metrics().snapshot()["counters"]
    stats = engine.stats()
    return {"statuses": statuses, "cancelled": cancelled, "cow": cow,
            "results": {r["request_id"]: (r["status"], r["tokens"])
                        for r in engine.poll()},
            "refs_before_drain": refs,
            "refs_after_drain": dict(engine.model.pool._ref),
            "handed_back": handed,
            "pages": {k: stats[k] for k in ("pages_used", "page_refs",
                                            "pages_reserved",
                                            "pages_cached")},
            "counters": {k: after.get(k, 0) - before.get(k, 0)
                         for k in COUNTERS}}


def test_engine_schedule_matches_jax(weights):
    jp, tp = weights
    kw = dict(kv_mode="paged", slots=4, max_len=64, page_size=8,
              prefill_chunk=16)
    want = _schedule(JEngine(jp, JCFG, **kw), jtelemetry.metrics)
    got = _schedule(ServingEngine(tp, CFG, device="cpu", **kw),
                    ttelemetry.metrics)
    assert want["cancelled"] and want["cow"]
    assert want["results"]["late"][0] == "expired"
    assert want["results"]["c"][0] == "cancelled"
    assert want["counters"]["prefix_hits"] == 1
    assert want["counters"]["pages_cow"] == 1
    assert want["handed_back"] == ["q"]
    assert got == want


# -- 4. the port's own contracts ----------------------------------------------

def _sample(tp, prompt, n, seed=None, **kw):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    out = sampling.sample(tp, torch.as_tensor(prompt).long()[None], CFG,
                          max_new_tokens=n, greedy=seed is None,
                          generator=gen, **kw)
    return out[0, len(prompt):].tolist()


MIX = [(np.arange(40) % CFG.vocab_size, 8),
       ((np.arange(7) * 3 + 1) % CFG.vocab_size, 6),
       ((np.arange(17) * 5 + 2) % CFG.vocab_size, 5),
       ((np.arange(16) * 7 + 3) % CFG.vocab_size, 4)]


def _run(engine, reqs):
    for rid, prompt, n, kw in reqs:
        assert engine.submit(rid, np.asarray(prompt, np.int32),
                             max_new_tokens=n, **kw)["status"] == "queued"
    engine.run_until_idle()
    return {r["request_id"]: r["tokens"] for r in engine.poll()}


def test_paged_greedy_equals_sample_and_slots(weights):
    _, tp = weights
    reqs = [(f"r{i}", p, n, {}) for i, (p, n) in enumerate(MIX)]
    paged = ServingEngine(tp, CFG, kv_mode="paged", slots=4, max_len=64,
                          device="cpu")
    got = _run(paged, reqs)
    slots = _run(ServingEngine(tp, CFG, kv_mode="slots", slots=4,
                               max_len=64, device="cpu"), reqs)
    for rid, prompt, n, _ in reqs:
        assert got[rid] == _sample(tp, prompt, n) == slots[rid]
    paged.drain(wait_ms=0)
    st = paged.stats()
    assert st["pages_used"] == st["page_refs"] == st["pages_reserved"] == 0


@pytest.mark.parametrize("kv_mode", ["paged", "slots"])
def test_seeded_request_equals_b1_sample_whatever_shares_its_batch(
        weights, kv_mode):
    _, tp = weights
    prompt, n = MIX[2]
    kw = dict(greedy=False, temperature=0.8, top_k=50, seed=17)
    alone = _run(ServingEngine(tp, CFG, kv_mode=kv_mode, slots=4,
                               max_len=64, device="cpu"),
                 [("s", prompt, n, kw)])["s"]
    others = [("g0", MIX[0][0], 8, {}),
              ("s2", MIX[1][0], 6, dict(kw, seed=3, temperature=1.3)),
              ("s", prompt, n, kw), ("g1", MIX[3][0], 4, {})]
    shared = _run(ServingEngine(tp, CFG, kv_mode=kv_mode, slots=4,
                                max_len=64, device="cpu"), others)
    want = _sample(tp, prompt, n, seed=17, temperature=0.8, top_k=50)
    assert alone == shared["s"] == want
    assert shared["g0"] == _sample(tp, MIX[0][0], 8)


def test_supervisor_crash_mid_chunked_prefill_exactly_once(weights):
    _, tp = weights
    sup = ServingSupervisor(tp, CFG, task_index=0, slots=4, max_len=64,
                            prefill_chunk=16, device="cpu")
    long_p = (np.arange(40) * 17 + 3) % CFG.vocab_size
    short_p = np.asarray([4, 5, 6])
    before = dict(ttelemetry.metrics().snapshot()["counters"])
    sup.submit("long", long_p.astype(np.int32), max_new_tokens=4)
    sup.submit("short", short_p.astype(np.int32), max_new_tokens=3)
    faults.configure("serve_fault:op=prefill,step=2,ti=0")
    try:
        sup.run_until_idle()
    finally:
        faults.configure(None)
    res = {r["request_id"]: r for r in sup.poll(["long", "short"])}
    after = ttelemetry.metrics().snapshot()["counters"]

    def d(k):
        return after.get(k, 0) - before.get(k, 0)

    assert d("fault_injected:serve_fault") == 1
    assert d("engine_restarts") == 1 and sup.restarts == 1
    assert d("requests_replayed") >= 1
    assert d("serve_requests_completed") == 2
    assert res["long"]["status"] == res["short"]["status"] == "done"
    assert res["long"]["tokens"] == _sample(tp, long_p, 4)
    assert res["short"]["tokens"] == _sample(tp, short_p, 3)


def test_threaded_scheduler_equals_lockstep(weights):
    """The scheduler thread enters no grad mode of its caller's: every
    servable method enters inference mode itself, so a threaded engine
    gives the lockstep tokens."""
    _, tp = weights
    reqs = [(f"r{i}", p, n, {}) for i, (p, n) in enumerate(MIX)]
    engine = ServingEngine(tp, CFG, slots=4, max_len=64, device="cpu")
    engine.start()
    try:
        for rid, prompt, n, _ in reqs:
            engine.submit(rid, np.asarray(prompt, np.int32),
                          max_new_tokens=n)
        res = engine.poll([r[0] for r in reqs], wait_ms=60_000)
    finally:
        engine.stop()
    assert all(r["status"] == "done" for r in res)
    for r, (rid, prompt, n, _) in zip(res, reqs):
        assert r["tokens"] == _sample(tp, prompt, n)


@pytest.mark.parametrize("greedy", [True, False])
def test_kv_handoff_between_engines_equals_sample(weights, greedy):
    """A prefill-only request parks with its pages; a second engine adopts
    them (export_pages / adopt_pages / complete_handoff) and decodes the
    tokens ``sample()`` gives, its generator resumed one draw in."""
    _, tp = weights
    prompt, n = MIX[0]
    kw = {} if greedy else dict(greedy=False, temperature=0.9, seed=5)
    src = ServingEngine(tp, CFG, slots=4, max_len=64, device="cpu")
    dst = ServingEngine(tp, CFG, slots=4, max_len=64, device="cpu")
    src.submit("h", prompt.astype(np.int32), max_new_tokens=n,
               prefill_only=True, **kw)
    src.run_until_idle()
    assert src.poll(["h"])[0]["status"] == "prefilled"
    out = dst.adopt_pages("h", prompt.astype(np.int32), max_new_tokens=n,
                          fetch=lambda want: src.export_pages("h", want),
                          **kw)
    assert out["status"] == "adopted"
    assert src.complete_handoff("h")
    dst.run_until_idle()
    got = dst.poll(["h"])[0]["tokens"]
    want = (_sample(tp, prompt, n) if greedy
            else _sample(tp, prompt, n, seed=5, temperature=0.9))
    assert got == want
    assert src.poll(["h"])[0]["status"] == "handed_off"
    src.drain(wait_ms=0)
    assert src.stats()["pages_used"] == 0


def test_entry_points_default_to_the_card(weights):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    _, tp = weights
    for make in (functools.partial(ServingEngine, tp, CFG),
                 functools.partial(ServingSupervisor, tp, CFG),
                 functools.partial(tpk.PagedServableModel, tp, CFG),
                 functools.partial(tkv.ServableModel, tp, CFG)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# -- 5. bf16 ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["prefill", "decode", "chunk_prefill",
                                  "paged_decode"])
def test_bf16_logits_within_twice_the_reference_gap(name):
    """The port's bf16 logits against the JAX function's fp32 ones, within
    twice the gap between the JAX function's bf16 and fp32 runs on the
    same bf16 weights and pools."""
    cfg16 = dataclasses.replace(CFG, dtype=torch.bfloat16)
    jcfg16 = dataclasses.replace(JCFG, dtype=jnp.bfloat16)
    jp16 = jax.device_get(jgpt2.init_params(jcfg16, jax.random.PRNGKey(0)))
    jp32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp16)
    tp16 = convert.to_torch(jp16, device="cpu")
    side16 = Side(cfg16, jcfg16, round_bf16=True)
    side32 = Side(CFG, JCFG, round_bf16=True)
    j16, t16 = EXECUTABLES[name](jp16, tp16, np.random.default_rng(9),
                                 side16)
    j32, _ = EXECUTABLES[name](jp32, convert.to_torch(jp32, device="cpu"),
                               np.random.default_rng(9), side32)
    gap = _rel_l2(_np(j16[0]), _np(j32[0]))
    assert gap > 0
    assert _rel_l2(_np(t16[0]), _np(j32[0])) <= 2 * gap
