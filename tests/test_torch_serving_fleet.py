"""The port's serving fleet (``serving/fleet.py``: stage partitioning,
``StageServable``, the planner-sharded ``ShardedServable``,
``load_fleet_servable`` and the prefill/decode ``FleetRouter``), and the
servicer's stage ``LoadServable`` and ``ExecuteServableSlice``, held to
the JAX package's ``tests/test_serving_fleet.py`` case by case.

Both sides serve the GPT-2 ``test`` weights (fp32, the JAX package's
initializer, crossing as numpy through ``convert.py``) from in-process
servicers (``inproc:`` addresses): the port's on the CPU, the JAX
package's on its virtual devices. Greedy fp32 tokens must be EQUAL: the
port's sharded and disaggregated tokens against the port's ``sample()``
and its single-pool engine, and against the JAX package's sharded
servable and router. Page counters (exported, adopted, reused, handoffs)
must equal the JAX side's for the same schedule, and zero pages may leak.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tepdist_tpu_torch import convert
from tepdist_tpu_torch.rpc.client import TepdistClient
from tepdist_tpu_torch.runtime import faults

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu_torch.models import gpt2

    jcfg = jgpt2.CONFIGS["test"]
    cfg = dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32)
    params = jax.device_get(jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, params, convert.to_torch(params, device="cpu")


@pytest.fixture(autouse=True)
def _clean_fault_plan():
    from tepdist_tpu.runtime import faults as jfaults
    faults.configure(None)
    jfaults.configure(None)
    yield
    faults.reset()
    jfaults.reset()


def _counters(pkg):
    if pkg == "jax":
        from tepdist_tpu.telemetry import metrics
    else:
        from tepdist_tpu_torch.telemetry import metrics
    return dict(metrics().snapshot()["counters"])


def _delta(after, before, key):
    return after.get(key, 0) - before.get(key, 0)


class _Cluster:
    """``n`` in-process servicers of one package and a client each."""

    def __init__(self, pkg, n):
        if pkg == "jax":
            from tepdist_tpu.rpc.client import TepdistClient as Client
            from tepdist_tpu.rpc.inproc import (close_inproc_cluster,
                                                make_inproc_cluster)
            self.cluster, self.servicers = make_inproc_cluster(
                n, jax.devices()[:n])
        else:
            from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                                      make_inproc_cluster)
            Client = TepdistClient
            self.cluster, self.servicers = make_inproc_cluster(n, ["cpu"])
        self._close = close_inproc_cluster
        self.clients = [Client(w.address) for w in self.cluster.workers]

    def leaked_pages(self, idx=None) -> int:
        sv = (self.servicers if idx is None
              else [self.servicers[i] for i in idx])
        return sum(int(e.stats().get("pages_used", 0))
                   for s in sv for e in s.servables.values())

    def close(self):
        for s in self.servicers:
            s.close_servables()
        self._close(self.cluster)


@pytest.fixture
def clusters():
    made = []

    def make(pkg, n):
        c = _Cluster(pkg, n)
        made.append(c)
        return c

    yield make
    for c in made:
        c.close()


def _fleet(pkg):
    if pkg == "jax":
        from tepdist_tpu.serving import fleet
    else:
        from tepdist_tpu_torch.serving import fleet
    return fleet


def _serving(pkg):
    if pkg == "jax":
        from tepdist_tpu import serving
    else:
        from tepdist_tpu_torch import serving
    return serving


def _side(weights, pkg):
    jcfg, cfg, jparams, tparams = weights
    return (jcfg, jparams) if pkg == "jax" else (cfg, tparams)


def _ref(weights, prompt, max_new, **kw):
    """The port's single-device ``sample()``."""
    from tepdist_tpu_torch.models.sampling import sample
    _, cfg, _, tparams = weights
    return sample(tparams, torch.as_tensor(np.asarray(prompt))[None].long(),
                  cfg, max_new_tokens=max_new, greedy=True,
                  **kw)[0].numpy().astype(np.int32)


def _prompts(specs):
    return [np.random.RandomState(s).randint(1, 512, size=t).astype(np.int32)
            for s, t in specs]


# ---------------------------------------------------------------------------
# stage partitioning units
# ---------------------------------------------------------------------------

def test_stage_ranges_and_param_names_equal_the_reference(weights):
    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu_torch.models import gpt2

    jf, tf = _fleet("jax"), _fleet("torch")
    for n_layer, n_stages in ((2, 2), (2, 1), (48, 2), (48, 4), (12, 3)):
        assert (tf.stage_ranges(n_layer, n_stages)
                == jf.stage_ranges(n_layer, n_stages))
    for bad in ((3, 2), (4, 0)):
        with pytest.raises(ValueError):
            tf.stage_ranges(*bad)
        with pytest.raises(ValueError):
            jf.stage_ranges(*bad)
    for name in ("test", "1.5B"):
        jc, tc = jgpt2.CONFIGS[name], gpt2.CONFIGS[name]
        for lo, hi in tf.stage_ranges(tc.n_layer, 2):
            for first, last in ((lo == 0, hi == tc.n_layer), (True, True)):
                assert (tf.stage_param_names(tc, lo, hi, first, last)
                        == jf.stage_param_names(jc, lo, hi, first, last))
    _, cfg, jparams, tparams = weights
    names = tf.stage_param_names(cfg, 1, 2, False, True)
    assert names[-3:] == ["wte", "ln_f_g", "ln_f_b"]
    leaves = [tf.resolve_leaf(tparams, n) for n in names]
    rebuilt = tf.build_stage_params(names, leaves)
    for n in names:
        np.testing.assert_array_equal(
            tf.resolve_leaf(rebuilt, n).numpy(),
            np.asarray(jf.resolve_leaf(jparams, n)))


def test_verify_sharded_servable_overflow_names_the_same_stage(weights):
    from tepdist_tpu.analysis import plan_verify as jpv
    from tepdist_tpu_torch.analysis import plan_verify as tpv

    jcfg, cfg, _, _ = weights
    stages = [(0, 1, True, False), (1, 2, False, True)]
    got = tpv.verify_sharded_servable(cfg, stages=stages, max_len=64,
                                      hbm_limit_bytes=1e9)
    want = jpv.verify_sharded_servable(jcfg, stages=stages, max_len=64,
                                       hbm_limit_bytes=1e9)
    assert got == want
    # A budget between the two stages' footprints: the larger one
    # overflows, on both sides by the same name and message.
    mid = (min(got.values()) + max(got.values())) / 2
    for limit in (1024.0, mid):
        with pytest.raises(tpv.PlanVerificationError) as te:
            tpv.verify_sharded_servable(cfg, stages=stages, max_len=64,
                                        hbm_limit_bytes=limit)
        with pytest.raises(jpv.PlanVerificationError) as je:
            jpv.verify_sharded_servable(jcfg, stages=stages, max_len=64,
                                        hbm_limit_bytes=limit)
        assert te.value.kind == je.value.kind == "hbm_overflow"
        assert str(te.value) == str(je.value)
    with pytest.raises(tpv.PlanVerificationError):
        tpv.verify_sharded_servable(cfg, stages=[(0, 0, True, True)],
                                    max_len=64, hbm_limit_bytes=1e9)


# ---------------------------------------------------------------------------
# planner-sharded servables
# ---------------------------------------------------------------------------

def test_sharded_tokens_equal_sample_and_the_jax_sharded_servable(
        weights, clusters):
    """A 2-stage split over 2 in-process workers: greedy tokens through
    the chained ``ExecuteServableSlice`` path equal the port's
    ``sample()`` and the JAX package's sharded servable; a seeded
    non-greedy request equals ``sample()`` with the same generator."""
    from tepdist_tpu_torch.models.sampling import sample

    prompts = _prompts(((1, 4), (2, 17), (3, 33)))
    out = {}
    for pkg in ("jax", "torch"):
        cfg, params = _side(weights, pkg)
        c = clusters(pkg, 2)
        sv = _fleet(pkg).load_sharded(c.clients, params, cfg,
                                      name="shards", max_len=64,
                                      plan={"num_stages": 2})
        assert sv.num_stages == 2
        out[pkg] = [np.asarray(sv.generate_one(p, max_new_tokens=5))
                    for p in prompts]
        if pkg == "torch":
            stats = [s.servables[sid].stats() for s, (_, sid)
                     in zip(c.servicers, sv.placements)]
            assert [st["stage"] for st in stats] == [[0, 1], [1, 2]]
            p = prompts[1]
            got = sv.generate_one(p, max_new_tokens=4, greedy=False,
                                  seed=3)
            _, tcfg, _, tparams = weights
            ref = sample(tparams, torch.as_tensor(p)[None].long(), tcfg,
                         max_new_tokens=4, greedy=False,
                         generator=torch.Generator().manual_seed(3))
            np.testing.assert_array_equal(got, ref[0].numpy())
    for p, t, j in zip(prompts, out["torch"], out["jax"]):
        np.testing.assert_array_equal(t, _ref(weights, p, 5))
        np.testing.assert_array_equal(t, j)


def test_hbm_overflow_routes_to_the_same_sharded_split(weights, clusters,
                                                       monkeypatch):
    """With the per-device HBM (``HBM_GB``) too small for weights + KV,
    ``load_fleet_servable`` routes through the planner on both sides: the
    same split, the same fallback flag (the tiny model's global best is
    SPMD, not executable as a serving split), the fallback counter
    ticking, and tokens equal to ``sample()`` and the JAX servable's."""
    from tepdist_tpu.core.service_env import ServiceEnv as JEnv
    from tepdist_tpu_torch.core.service_env import ServiceEnv

    monkeypatch.setenv("HBM_GB", "0.0005")
    ServiceEnv.reset()
    JEnv.reset()
    p = np.arange(1, 12, dtype=np.int32)
    got = {}
    try:
        for pkg in ("jax", "torch"):
            cfg, params = _side(weights, pkg)
            c = clusters(pkg, 2)
            before = _counters(pkg)
            sv = _fleet(pkg).load_fleet_servable(c.clients, params, cfg,
                                                 name="auto", max_len=64)
            assert isinstance(sv, _fleet(pkg).ShardedServable)
            assert _delta(_counters(pkg), before,
                          "serve_shard_plan_fallback") == 1
            got[pkg] = (sv.num_stages, sv.plan["fallback"],
                        sv.plan["chosen"]["kind"],
                        sv.plan["chosen"]["placement"],
                        np.asarray(sv.generate_one(p, max_new_tokens=4)))
    finally:
        monkeypatch.delenv("HBM_GB")
        ServiceEnv.reset()
        JEnv.reset()
    assert got["torch"][:4] == got["jax"][:4] == (2, True, "pipeline",
                                                  "blocked")
    np.testing.assert_array_equal(got["torch"][4], got["jax"][4])
    np.testing.assert_array_equal(got["torch"][4], _ref(weights, p, 4))


def test_fits_one_device_stays_replicated(weights, clusters):
    from tepdist_tpu_torch.serving import ServeClient

    cfg, params = _side(weights, "torch")
    c = clusters("torch", 2)
    sv = _fleet("torch").load_fleet_servable(c.clients, params, cfg,
                                             name="fits", max_len=64)
    assert isinstance(sv, ServeClient)
    p = np.arange(2, 9, dtype=np.int32)
    np.testing.assert_array_equal(sv.generate([p], max_new_tokens=4)[0],
                                  _ref(weights, p, 4))


# ---------------------------------------------------------------------------
# prefill/decode disaggregation
# ---------------------------------------------------------------------------

def _page_deltas(after, before):
    return {k: _delta(after, before, k)
            for k in ("kv_pages_exported", "kv_pages_adopted",
                      "pool_handoffs")}


def test_disagg_tokens_and_pages_equal_both_engines(weights, clusters):
    """1 prefill + 1 decode replica: greedy tokens equal the port's
    ``sample()``, its single-pool engine and the JAX router's; exactly
    the live pages move (the same counts as the JAX side), and zero
    pages leak after draining both pools."""
    from tepdist_tpu_torch.serving import ServeClient, pages_for

    prompts = _prompts(((0, 5), (1, 17), (2, 33)))
    toks, moved = {}, {}
    for pkg in ("jax", "torch"):
        cfg, params = _side(weights, pkg)
        c = clusters(pkg, 2 if pkg == "jax" else 3)
        before = _counters(pkg)
        router = _fleet(pkg).FleetRouter(c.clients[:2], prefill=1,
                                         decode=1)
        router.load(params, cfg, max_len=64, name="disagg")
        toks[pkg] = router.generate(prompts, max_new_tokens=6)
        router.drain_all(wait_ms=5000.0)
        assert c.leaked_pages([0, 1]) == 0
        moved[pkg] = _page_deltas(_counters(pkg), before)
        assert len(router.handoff_ms) == len(router.ttft_ms) == 3
        if pkg == "torch":
            single = ServeClient(clients=c.clients[2:])
            single.load(params, cfg, max_len=64, name="single",
                        kv_mode="paged")
            pool = single.generate(prompts, max_new_tokens=6)
            live = sum(pages_for(len(p), router.page_size)
                       for p in prompts)
    for p, t, j, s in zip(prompts, toks["torch"], toks["jax"], pool):
        np.testing.assert_array_equal(t, _ref(weights, p, 6))
        np.testing.assert_array_equal(t, s)
        np.testing.assert_array_equal(t, j)
    assert moved["torch"] == moved["jax"] == {
        "kv_pages_exported": live, "kv_pages_adopted": live,
        "pool_handoffs": len(prompts)}


def test_prefix_hit_pages_never_reshipped(weights, clusters):
    """A repeat prompt whose prefix the decode replica already cached
    adopts those pages locally: the export ships only the fresh tail
    pages, with the same counts as the JAX side."""
    from tepdist_tpu_torch.serving import pages_for

    p = _prompts(((5, 34),))[0]
    got = {}
    for pkg in ("jax", "torch"):
        cfg, params = _side(weights, pkg)
        c = clusters(pkg, 2)
        router = _fleet(pkg).FleetRouter(c.clients, prefill=1, decode=1)
        router.load(params, cfg, max_len=64, name="reuse")
        before = _counters(pkg)
        first = router.generate([p], max_new_tokens=4)[0]
        mid = _counters(pkg)
        second = router.generate([p], max_new_tokens=4)[0]
        np.testing.assert_array_equal(first, second)
        router.drain_all(wait_ms=5000.0)
        assert c.leaked_pages() == 0
        end = _counters(pkg)
        got[pkg] = (first,
                    _delta(mid, before, "kv_pages_exported"),
                    _delta(end, mid, "kv_pages_reused"),
                    _delta(end, mid, "kv_pages_exported"))
    live = pages_for(len(p), 16)
    first, shipped0, reused, shipped = got["torch"]
    np.testing.assert_array_equal(first, _ref(weights, p, 4))
    np.testing.assert_array_equal(first, got["jax"][0])
    assert got["torch"][1:] == got["jax"][1:]
    assert shipped0 == live and reused >= 2 and shipped == live - reused


def test_adopt_pages_exactly_once_under_the_reference_fault_spec(
        weights, clusters):
    """``AdoptPages`` under the JAX test's fault spec (``rpc_drop``, lost
    and applied-but-unacked, and ``server_fault``): tokens equal
    ``sample()``, each request's live pages are adopted exactly once, and
    zero pages leak."""
    from tepdist_tpu_torch.serving import pages_for

    prompts = _prompts(((3, 7), (4, 19), (5, 12), (6, 30)))
    cfg, params = _side(weights, "torch")
    c = clusters("torch", 3)
    router = _fleet("torch").FleetRouter(c.clients, prefill=1, decode=2)
    router.load(params, cfg, max_len=64, name="chaos")
    before = _counters("torch")
    faults.configure("rpc_drop:verb=AdoptPages,p=0.5,seed=11;"
                     "server_fault:verb=AdoptPages,p=0.3")
    try:
        outs = router.generate(prompts, max_new_tokens=5)
    finally:
        faults.configure(None)
    for p, o in zip(prompts, outs):
        np.testing.assert_array_equal(o, _ref(weights, p, 5))
    router.drain_all(wait_ms=5000.0)
    assert c.leaked_pages() == 0
    d = _counters("torch")
    assert (_delta(d, before, "fault_injected:rpc_drop")
            + _delta(d, before, "fault_injected:server_fault")) >= 1
    live = sum(pages_for(len(p), router.page_size) for p in prompts)
    assert _delta(d, before, "kv_pages_adopted") == live
    assert _delta(d, before, "rpc_retries") >= 1


def test_decode_replica_death_mid_handoff_replays_exactly_once(
        weights, clusters):
    """The port of ``test_serving_chaos.py``'s case: decode replica d0
    dies between submit and handoff; every ``AdoptPages`` fails over to
    d1 and adopts exactly once, tokens equal ``sample()``, and no page
    leaks on the live replicas."""
    from tepdist_tpu_torch.rpc.inproc import unregister_servicer
    from tepdist_tpu_torch.serving import pages_for

    rng = np.random.RandomState(13)
    prompts = [rng.randint(1, 512, size=int(rng.randint(5, 20))).astype(
        np.int32) for _ in range(4)]
    mnts = [int(m) for m in rng.randint(2, 7, size=4)]
    cfg, params = _side(weights, "torch")
    c = clusters("torch", 3)
    router = _fleet("torch").FleetRouter(c.clients, prefill=1, decode=2)
    router.load(params, cfg, max_len=64, name="ddeath")
    before = _counters("torch")
    rids = [router.submit(p, max_new_tokens=m)["request_id"]
            for p, m in zip(prompts, mnts)]
    unregister_servicer(c.cluster.workers[1].address)
    for rid in rids:
        out = router.handoff(rid, timeout_s=120)
        assert out["status"] in ("adopted", "duplicate")
    results = router.wait(rids, timeout_s=300)
    for p, m, rid in zip(prompts, mnts, rids):
        assert results[rid]["status"] == "done"
        np.testing.assert_array_equal(
            np.asarray(results[rid]["tokens"], np.int32),
            _ref(weights, p, m)[len(p):])
    router.drain_all(wait_ms=5000.0)
    assert c.leaked_pages([0, 2]) == 0
    d = _counters("torch")
    live = sum(pages_for(len(p), router.page_size) for p in prompts)
    assert _delta(d, before, "kv_pages_adopted") == live
    assert _delta(d, before, "pool_handoffs") == len(prompts)


def test_prefix_affinity_hits_match_the_reference(weights, clusters):
    """Repeat prefixes pin to the prefill replica that already holds
    their pages (``prefix_affinity_hits``), as many times as on the JAX
    side; ``ServeClient``'s opt-in places identical prompts on one
    replica on both sides."""
    p = _prompts(((9, 20),))[0]
    q = _prompts(((8, 18),))[0]
    hits = {}
    for pkg in ("jax", "torch"):
        cfg, params = _side(weights, pkg)
        c = clusters(pkg, 3)
        router = _fleet(pkg).FleetRouter(c.clients, prefill=2, decode=1)
        router.load(params, cfg, max_len=64, name="affine")
        before = _counters(pkg)
        outs = [router.generate([p], max_new_tokens=3)[0]
                for _ in range(3)]
        np.testing.assert_array_equal(outs[0], outs[1])
        d = _counters(pkg)
        hits[pkg] = _delta(d, before, "prefix_affinity_hits")
        assert _delta(d, before, "prefix_hits") >= 1
        if pkg == "torch":
            np.testing.assert_array_equal(outs[0], _ref(weights, p, 3))
        sc = _serving(pkg).ServeClient(clients=c.clients[:2],
                                       prefix_affinity=True)
        sc.load(params, cfg, max_len=64, name="affine-sc")
        rids = [sc.submit(q, max_new_tokens=2)["request_id"]
                for _ in range(3)]
        assert len({sc._where[r][0].stub.address for r in rids}) == 1
        sc.wait(rids, timeout_s=120)
    assert hits["torch"] == hits["jax"] == 2


def test_export_release_idempotent_and_adopt_dedup(weights, clusters):
    """A repeated release answers True again, and a replayed
    ``AdoptPages`` (fresh idem token, same request id) is answered
    "duplicate" without pulling a page."""
    p = np.arange(1, 20, dtype=np.int32)
    cfg, params = _side(weights, "torch")
    c = clusters("torch", 2)
    router = _fleet("torch").FleetRouter(c.clients, prefill=1, decode=1)
    router.load(params, cfg, max_len=64, name="idem")
    rid = router.submit(p, max_new_tokens=3)["request_id"]
    router.handoff(rid, timeout_s=60)
    pc, psid = router._prefill[0]
    dc, dsid = router._decode[0]
    assert pc.export_pages(psid, rid, release=True)["released"]
    before = _counters("torch")
    dup = dc.adopt_pages(dsid, rid, p, source_addr=pc.stub.address,
                         source_sid=psid, max_new_tokens=3)
    assert dup["status"] == "duplicate"
    assert _delta(_counters("torch"), before, "kv_pages_adopted") == 0
    res = router.wait([rid], timeout_s=120)[rid]
    np.testing.assert_array_equal(
        np.concatenate([p, np.asarray(res["tokens"], np.int32)]),
        _ref(weights, p, 3))


def test_router_handoff_fenced_by_epoch(weights, clusters):
    """A router armed at the old master's epoch gets ``StaleEpochError``
    on the handoff and on submit once a new master latches a higher
    epoch, moves no page, and completes the same request once re-armed
    at the live epoch."""
    from tepdist_tpu_torch.rpc import retry

    p = _prompts(((3, 7),))[0]
    cfg, params = _side(weights, "torch")
    c = clusters("torch", 2)
    router = _fleet("torch").FleetRouter(c.clients, prefill=1, decode=1)
    router.load(params, cfg, max_len=64, name="fence")
    router.set_epoch(5)
    rid = router.submit(p, max_new_tokens=4)["request_id"]
    assert c.servicers[0].master_epoch == 5
    pages_before = _counters("torch").get("kv_pages_adopted", 0)
    usurpers = [TepdistClient(w.address) for w in c.cluster.workers]
    for u in usurpers:
        u.epoch = 6
        u.call("AbortStep", {"reset": True})
    assert all(s.master_epoch == 6 for s in c.servicers)
    with pytest.raises(retry.StaleEpochError):
        router.handoff(rid, timeout_s=30)
    with pytest.raises(retry.StaleEpochError):
        router.submit(p, max_new_tokens=4)
    assert _counters("torch").get("kv_pages_adopted", 0) == pages_before
    router.set_epoch(6)
    router.handoff(rid, timeout_s=60)
    res = router.wait([rid], timeout_s=120)[rid]
    assert res["status"] == "done"
    np.testing.assert_array_equal(
        np.concatenate([p, np.asarray(res["tokens"], np.int32)]),
        _ref(weights, p, 4))
    for u in usurpers:
        u.close()
