"""The port's serving client (``serving/client.py``: ``ServeClient``,
``_Breaker``, ``ServeOverloadError``) and the servable verbs of
``rpc/server.py`` held to the JAX package's: the same GPT-2 ``test``
weights (fp32, the JAX package's initializer, crossing as numpy) served
by two in-process servers (``inproc:`` addresses) on each side.

Greedy fp32 tokens must be EQUAL to the JAX ServeClient's over its own
servers, request by request: through ``generate``, through a ``Drain``
that hands queued requests to the other replica, and through one KV
handoff (a prefill-only request exported from one replica and adopted by
the other: ``ExportPages``/``AdoptPages``). A replayed cancel is answered
from the server's idempotency cache, as the JAX server answers it.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tepdist_tpu_torch import convert

torch.set_num_threads(2)

_PORTS = itertools.count(7400)
ENGINE = dict(slots=2, max_len=64, page_size=8)


@pytest.fixture(scope="module")
def weights():
    from tepdist_tpu.models import gpt2 as jgpt2
    from tepdist_tpu_torch.models import gpt2

    jcfg = dataclasses.replace(jgpt2.CONFIGS["test"], dtype=jnp.float32)
    cfg = dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32)
    params = jax.device_get(jgpt2.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, params


def _prompts():
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, 500, 16)
    return [np.concatenate([prefix, rng.integers(1, 500, n)]).astype(
        np.int32) if i % 2 else rng.integers(1, 500, 8 + n).astype(np.int32)
        for i, n in enumerate((5, 9, 13, 3, 7, 11))]


class _Side:
    """Two servers of one package behind ``inproc:`` addresses, and its
    ServeClient over them."""

    def __init__(self, pkg, weights):
        jcfg, cfg, params = weights
        if pkg == "jax":
            from tepdist_tpu.rpc import inproc
            from tepdist_tpu.rpc.server import TepdistServicer
            from tepdist_tpu.serving.client import ServeClient
            self.servicers = [TepdistServicer(jax.devices()[:1],
                                              task_index=i)
                              for i in range(2)]
            self.cfg, self.params = jcfg, params
        else:
            from tepdist_tpu_torch.rpc import inproc
            from tepdist_tpu_torch.rpc.server import TepdistServicer
            from tepdist_tpu_torch.serving.client import ServeClient
            self.servicers = [TepdistServicer(["cpu"], task_index=i)
                              for i in range(2)]
            self.cfg = cfg
            self.params = convert.to_torch(params, device="cpu")
        self.inproc = inproc
        self.addresses = [f"inproc:{next(_PORTS)}" for _ in range(2)]
        for a, sv in zip(self.addresses, self.servicers):
            inproc.register_servicer(a, sv)
        self.client = ServeClient(self.addresses)
        self.sids = self.client.load(self.params, self.cfg, **ENGINE)

    def close(self):
        self.client.close()
        for a, sv in zip(self.addresses, self.servicers):
            sv.close_servables()
            self.inproc.unregister_servicer(a)


@pytest.fixture
def sides(weights):
    made = []

    def make(pkg):
        s = _Side(pkg, weights)
        made.append(s)
        return s

    yield make
    for s in made:
        s.close()


def _tokens(results):
    return {rid: list(r["tokens"]) for rid, r in results.items()}


def test_generate_matches_jax(sides):
    """Six greedy requests, half sharing a 16-token prefix, round-robin
    over the two replicas: prompt + generated tokens equal the JAX
    ServeClient's."""
    prompts = _prompts()
    got = [sides(pkg).client.generate(prompts, max_new_tokens=6)
           for pkg in ("jax", "torch")]
    for j, t in zip(*got):
        np.testing.assert_array_equal(t, j)


def test_drain_hands_off_to_the_other_replica(sides):
    """With one slot a replica, replica 1 is drained while its queue
    holds requests: they come back and are resubmitted on replica 0
    under their own ids, and every request's tokens equal the JAX side's
    for the same schedule."""
    prompts = _prompts()
    out = {}
    for pkg in ("jax", "torch"):
        side = sides(pkg)
        rids = [side.client.submit(p, max_new_tokens=6,
                                   request_id=f"q{i}")["request_id"]
                for i, p in enumerate(prompts)]
        report = side.client.drain(1, wait_ms=0.0)
        res = side.client.wait(rids, timeout_s=120)
        assert all(r["status"] == "done" for r in res.values()), res
        out[pkg] = (_tokens(res), report)
    assert out["torch"][0] == out["jax"][0]
    assert not out["torch"][1]["failed"]
    assert (out["torch"][1]["handed_off"]
            == len(out["torch"][1]["resubmitted"]))


def test_replayed_cancel_is_answered_from_the_cache(sides):
    """A CancelRequest replayed with its idempotency token gets the
    original answer from the cache (``dedup_hits`` counts it); both
    packages answer the same bytes' fields."""
    answers = {}
    for pkg in ("jax", "torch"):
        side = sides(pkg)
        if pkg == "jax":
            from tepdist_tpu.rpc import protocol
            from tepdist_tpu.telemetry import metrics
        else:
            from tepdist_tpu_torch.rpc import protocol
            from tepdist_tpu_torch.telemetry import metrics
        rid = side.client.submit(_prompts()[0],
                                 max_new_tokens=40)["request_id"]
        c, sid = side.client._where[rid]
        before = metrics().counter("dedup_hits").value
        header = {"servable_id": sid, "request_id": rid,
                  "idem": f"cancel-{pkg}"}
        first = protocol.unpack(c.call("CancelRequest", header))[0]
        again = protocol.unpack(c.call("CancelRequest", header))[0]
        assert metrics().counter("dedup_hits").value == before + 1
        assert again == first
        side.client.wait([rid], timeout_s=60)
        answers[pkg] = {k: first[k] for k in ("ok", "cancelled")}
    assert answers["torch"] == answers["jax"]


def test_kv_handoff_between_replicas(sides):
    """A prefill-only request on replica 0 parks with its pages; replica
    1 adopts them (``AdoptPages`` pulling ``ExportPages`` from replica 0),
    replica 0 releases them, and replica 1 decodes: the tokens equal the
    JAX side's for the same handoff and its own generate."""
    p = _prompts()[1]
    out = {}
    for pkg in ("jax", "torch"):
        side = sides(pkg)
        (c0, s0), (c1, s1) = side.client._placements
        c0.submit_request(s0, "h", p, max_new_tokens=6, prefill_only=True)
        for _ in range(600):
            st = c0.poll_result(s0, ["h"], wait_ms=50)[0]["status"]
            if st == "prefilled":
                break
        assert st == "prefilled"
        adopted = c1.adopt_pages(s1, "h", p,
                                 source_addr=side.addresses[0],
                                 source_sid=s0, max_new_tokens=6)
        assert adopted["status"] == "adopted"
        assert c0.export_pages(s0, "h", release=True)["released"]
        for _ in range(600):
            r = c1.poll_result(s1, ["h"], wait_ms=50)[0]
            if r["status"] == "done":
                break
        out[pkg] = (list(r["tokens"]),
                    list(side.client.generate([p], max_new_tokens=6)[0]
                         [len(p):]))
    assert out["torch"][0] == out["jax"][0] == out["torch"][1]


def test_breaker_opens_on_a_dead_replica(sides):
    """A replica that stops answering: submits fail over to the other,
    its breaker opens after ``breaker_threshold`` failures (the
    ``serve_breaker_open`` gauge reads 1), and with both gone a submit
    raises ``ServeOverloadError``."""
    from tepdist_tpu_torch.serving.client import ServeOverloadError
    from tepdist_tpu_torch.telemetry import metrics

    side = sides("torch")
    side.client._breaker_threshold = 1
    for br in side.client.breakers:
        br.threshold = 1
    side.inproc.unregister_servicer(side.addresses[1])
    rids = [side.client.submit(p, max_new_tokens=2)["request_id"]
            for p in _prompts()[:3]]
    assert {side.client._where[r][1] for r in rids} == {side.sids[0]}
    assert side.client.breakers[1].state == "open"
    assert metrics().gauge("serve_breaker_open").value == 1
    side.client.wait(rids, timeout_s=60)
    side.inproc.unregister_servicer(side.addresses[0])
    with pytest.raises(ServeOverloadError):
        side.client.submit(_prompts()[0], max_new_tokens=2)
