"""Serving load generator: the port of ``tools/serve_load.py``. Drive a
continuous-batching fleet and report latency and throughput (the serving
analogue of ``tools/torch_chaos_run.py``).

Spins up an in-process worker fleet (``rpc/inproc.py``: no sockets) on
``--device`` (the card unless ``--device cpu``), loads a servable on every
worker, fires a randomized request mix (prompt lengths, output lengths,
optional deadlines; drawn from ``np.random.RandomState(seed)`` exactly as
the JAX tool draws it, so the mixes are identical) through the
round-robin ``ServeClient`` (or, with ``--disagg P:D``, the
prefill/decode ``FleetRouter``), and prints completion counts, token
throughput and TTFT / per-token latency from the always-on metrics
registry. ``--fault-spec`` injects RPC faults (``runtime/faults.py``
grammar) under load; ``--trace`` dumps the merged timeline.

Run: python tools/torch_serve_load.py [--requests 32 --workers 2 --slots 4]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_load(config: str = "test", workers: int = 2, slots: int = 4,
             requests: int = 32, max_len: int = 64,
             prompt_len: (int, int) = (3, 16),
             max_new: (int, int) = (2, 10), seed: int = 0,
             greedy: bool = True, deadline_ms: Optional[float] = None,
             fault_spec: Optional[str] = None,
             trace: Optional[str] = None,
             timeout_s: float = 300.0,
             kv_mode: str = "paged", page_size: int = 16,
             hbm_budget_bytes: Optional[float] = None,
             prefill_chunk: Optional[int] = None,
             shared_prefix: int = 0,
             long_prompt: int = 0,
             disagg: Optional[str] = None, device: str = "cuda",
             params=None) -> Dict[str, Any]:
    """One load run; ``params`` (the model's tree) defaults to the port's
    seeded init of ``config``. Returns the summary."""
    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.rpc.client import TepdistClient
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime import faults
    from tepdist_tpu_torch.serving import FleetRouter, ServeClient

    # --disagg P:D — route through the prefill/decode FleetRouter
    # (serving/fleet.py) instead of the round-robin ServeClient.
    pools = None
    if disagg:
        p_n, d_n = (int(x) for x in disagg.split(":"))
        if kv_mode != "paged":
            raise ValueError("--disagg needs kv_mode='paged' "
                             "(the handoff moves KV pages)")
        pools = (p_n, d_n)
        workers = max(workers, p_n + d_n)

    if trace:
        telemetry.trace.configure(enabled=True)
    cfg = gpt2.CONFIGS[config]
    if params is None:
        params = gpt2.init_params(cfg, seed=0, device="cpu")
    cluster, servicers = make_inproc_cluster(workers, devices=[device])
    clients = [TepdistClient(w.address) for w in cluster.workers]
    sc = (FleetRouter(clients, prefill=pools[0], decode=pools[1])
          if pools else ServeClient(clients=clients))
    rng = np.random.RandomState(seed)
    before = telemetry.metrics().snapshot()
    # --shared-prefix: every request opens with the SAME system prompt,
    # so the paged engine's prefix cache should absorb the shared span
    # after the first prefill per worker (prefix_hit_rate below).
    if shared_prefix + 2 > max_len:
        raise ValueError(
            f"--shared-prefix {shared_prefix} leaves no room for a "
            f"prompt tail + one generated token within --max-len "
            f"{max_len} (need shared_prefix + 2 <= max_len)")
    system = (rng.randint(0, cfg.vocab_size,
                          size=shared_prefix).astype(np.int32)
              if shared_prefix else np.zeros(0, np.int32))
    try:
        if pools:
            sc.load(params, cfg, slots=slots, max_len=max_len,
                    name="loadgen", page_size=page_size,
                    hbm_budget_bytes=hbm_budget_bytes,
                    prefill_chunk=prefill_chunk)
        else:
            sc.load(params, cfg, slots=slots, max_len=max_len,
                    name="loadgen", kv_mode=kv_mode, page_size=page_size,
                    hbm_budget_bytes=hbm_budget_bytes,
                    prefill_chunk=prefill_chunk)
        reqs: List[Dict[str, Any]] = []
        if fault_spec:
            faults.configure(fault_spec)
        t0 = time.perf_counter()
        try:
            for i in range(requests):
                t = int(rng.randint(prompt_len[0], prompt_len[1] + 1))
                m = int(rng.randint(max_new[0], max_new[1] + 1))
                if long_prompt and i == 0:
                    # One long prompt in flight: with chunked prefill the
                    # short requests' TTFT p99 must not hide behind it.
                    t = max(t, long_prompt - len(system))
                # Clamp to >= 1 so a large --shared-prefix or a
                # --long-prompt near max_len shrinks the tail/output
                # instead of driving t or m negative.
                t = max(1, min(t, max_len - len(system) - m))
                m = max(1, min(m, max_len - len(system) - t))
                tail = rng.randint(0, cfg.vocab_size,
                                   size=t).astype(np.int32)
                prompt = np.concatenate([system, tail])
                out = sc.submit(prompt, max_new_tokens=m, greedy=greedy,
                                seed=i, deadline_ms=deadline_ms)
                reqs.append({"rid": out["request_id"],
                             "prompt_len": len(prompt), "max_new": m,
                             "admission": out["status"]})
            if pools:
                # Disaggregated path: move each prefilled request's KV
                # pages to the decode pool before waiting on results.
                for r in reqs:
                    sc.handoff(r["rid"], timeout_s=timeout_s)
            results = sc.wait([r["rid"] for r in reqs],
                              timeout_s=timeout_s)
        finally:
            if fault_spec:
                faults.reset()
        wall_s = time.perf_counter() - t0
        statuses: Dict[str, int] = {}
        n_tokens = 0
        ttfts = []
        decode_ms = []
        for r in reqs:
            res = results[r["rid"]]
            statuses[res["status"]] = statuses.get(res["status"], 0) + 1
            n_tokens += res.get("n_tokens", 0)
            if "ttft_ms" in res:
                ttfts.append(res["ttft_ms"])
            if "decode_ms" in res:
                decode_ms.append(res["decode_ms"])
        disagg_leak = None
        if pools:
            # Zero-page-leak gate: after both pools drain, every
            # servable on every worker must hold no used pages — a
            # handoff that left a page referenced on either side shows
            # up here.
            sc.drain_all(wait_ms=5000.0)
            disagg_leak = 0
            for s in servicers:
                for eng in s.servables.values():
                    disagg_leak += int(eng.stats().get("pages_used", 0))
        trace_path = sc.dump_trace(trace) if trace else None
    finally:
        for s in servicers:
            s.close_servables()
        close_inproc_cluster(cluster)
    after = telemetry.metrics().snapshot()

    def delta(name: str) -> int:
        return (after["counters"].get(name, 0)
                - before["counters"].get(name, 0))

    tok_hist = after.get("histograms", {}).get("serve_token_ms", {})
    ttft_hist = after.get("histograms", {}).get("serve_ttft_ms", {})

    def _slo(vals) -> Dict[str, Optional[float]]:
        # SLO percentiles, not means — p95/p99 are what a latency SLO is
        # written against.
        if not len(vals):
            return {"mean": None, "p50": None, "p95": None,
                    "p99": None, "max": None}
        return {"mean": round(float(np.mean(vals)), 3),
                "p50": round(float(np.percentile(vals, 50)), 3),
                "p95": round(float(np.percentile(vals, 95)), 3),
                "p99": round(float(np.percentile(vals, 99)), 3),
                "max": round(float(np.max(vals)), 3)}

    prefix_hits = delta("prefix_hits")
    summary = {
        "requests": requests,
        "statuses": statuses,
        "kv_mode": kv_mode,
        "wall_s": round(wall_s, 3),
        "tokens": n_tokens,
        "tokens_per_s": round(n_tokens / wall_s, 2) if wall_s else None,
        "ttft_ms": _slo(ttfts),
        # Reservoir-percentile view of the same SLO (the registry's
        # serve_ttft_ms histogram — survives across runs/restarts where
        # the per-request list above is this call's sample only).
        "ttft_hist_ms": {
            k: (round(ttft_hist[k], 3)
                if ttft_hist.get(k) is not None else None)
            for k in ("mean", "p50", "p95", "p99", "max")}
        if ttft_hist else None,
        "token_ms": {
            k: (round(tok_hist[k], 3)
                if tok_hist.get(k) is not None else None)
            for k in ("mean", "p50", "p95", "p99", "max")},
        "token_ms_mean": round(tok_hist.get("mean", 0.0), 3)
        if tok_hist else None,
        "decode_ms_mean": (round(float(np.mean(decode_ms)), 3)
                           if decode_ms else None),
        "decode_steps": delta("serve_decode_steps"),
        "prefills": delta("serve_prefills"),
        "prefill_chunks": delta("prefill_chunks"),
        "prefill_tokens": delta("serve_prefill_tokens"),
        "prefix_hits": prefix_hits,
        "prefix_hit_tokens": delta("prefix_hit_tokens"),
        "prefix_hit_rate": (round(prefix_hits / requests, 3)
                            if requests else None),
        "prefix_evictions": delta("prefix_evictions"),
        "pages_used_after_drain": (
            int(after.get("gauges", {}).get("pages_used", 0))
            if kv_mode == "paged" else None),
        "compiles": delta("serve_compiles"),
        "rpc_retries": delta("rpc_retries"),
        "dedup_hits": delta("dedup_hits"),
        "shed": delta("serve_shed"),
        "engine_restarts": delta("engine_restarts"),
        "requests_replayed": delta("requests_replayed"),
        "drain_handoffs": delta("drain_handoffs"),
        "breaker_trips": delta("serve_breaker_trips"),
        "disagg": disagg,
        "disagg_ttft_ms": (round(float(np.mean(sc.ttft_ms)), 3)
                           if pools and sc.ttft_ms else None),
        "kv_handoff_ms": (round(float(np.mean(sc.handoff_ms)), 3)
                          if pools and sc.handoff_ms else None),
        "pool_handoffs": delta("pool_handoffs") if pools else None,
        "kv_pages_exported": (delta("kv_pages_exported")
                              if pools else None),
        "kv_pages_adopted": (delta("kv_pages_adopted")
                             if pools else None),
        "kv_pages_reused": delta("kv_pages_reused") if pools else None,
        "prefix_affinity_hits": (delta("prefix_affinity_hits")
                                 if pools else None),
        "disagg_pages_leaked": disagg_leak,
        "trace": trace_path,
    }
    return summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser("torch_serve_load")
    ap.add_argument("--config", default="test")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(3, 16))
    ap.add_argument("--max-new", type=int, nargs=2, default=(2, 10))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-mode", choices=("paged", "slots"),
                    default="paged")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--hbm-budget", type=float, default=None,
                    help="emulated HBM bytes for the paged pool "
                         "(sizes n_pages; default: slots-compat)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked-prefill tokens per scheduler "
                         "iteration (default 2x page size)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a SHARED system prompt of N tokens to "
                         "every request (prefix-cache workload)")
    ap.add_argument("--long-prompt", type=int, default=0,
                    help="make request 0 a long prompt of ~N tokens "
                         "(chunked-prefill TTFT interference probe)")
    ap.add_argument("--disagg", default=None, metavar="P:D",
                    help="disaggregated serving: P prefill + D decode "
                         "replicas with paged KV handoff (FleetRouter)")
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--fault-spec", default=None,
                    help="runtime/faults.py grammar, e.g. "
                         "'rpc_drop:verb=SubmitRequest,p=0.3,seed=7'")
    ap.add_argument("--trace", default=None,
                    help="dump the merged trace JSON here")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="also write the summary JSON here (the file "
                         "tools/perf_gate.py --serve-json consumes)")
    ap.add_argument("--device", default="cuda",
                    help="the workers' device: cuda (the card, the "
                         "default) or cpu")
    args = ap.parse_args(argv)
    if args.shared_prefix + 2 > args.max_len:
        ap.error(f"--shared-prefix {args.shared_prefix} leaves no room "
                 f"for a prompt tail + one generated token within "
                 f"--max-len {args.max_len}")
    return args


def run(args, params=None, batch=None) -> Dict[str, Any]:
    """``run_load`` with ``args``; prints the summary and returns it."""
    summary = run_load(
        config=args.config, workers=args.workers, slots=args.slots,
        requests=args.requests, max_len=args.max_len,
        prompt_len=tuple(args.prompt_len), max_new=tuple(args.max_new),
        seed=args.seed, deadline_ms=args.deadline_ms,
        fault_spec=args.fault_spec, trace=args.trace,
        kv_mode=args.kv_mode, page_size=args.page_size,
        hbm_budget_bytes=args.hbm_budget,
        prefill_chunk=args.prefill_chunk,
        shared_prefix=args.shared_prefix,
        long_prompt=args.long_prompt,
        disagg=args.disagg, device=args.device, params=params)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(f"{summary['requests']} requests -> {summary['statuses']} "
              f"in {summary['wall_s']}s "
              f"({summary['tokens_per_s']} tok/s, "
              f"kv={summary['kv_mode']})")
        print(f"  ttft ms: {summary['ttft_ms']}")
        if summary["ttft_hist_ms"]:
            print(f"  ttft ms (reservoir): {summary['ttft_hist_ms']}")
        print(f"  token ms: {summary['token_ms']}  "
              f"decode_ms mean: {summary['decode_ms_mean']}")
        print(f"  prefills={summary['prefills']} "
              f"chunks={summary['prefill_chunks']} "
              f"decode_steps={summary['decode_steps']} "
              f"compiles={summary['compiles']} "
              f"retries={summary['rpc_retries']} "
              f"dedup={summary['dedup_hits']}")
        print(f"  prefix_hits={summary['prefix_hits']} "
              f"(rate {summary['prefix_hit_rate']}, "
              f"{summary['prefix_hit_tokens']} tokens) "
              f"evictions={summary['prefix_evictions']} "
              f"pages_used_after_drain="
              f"{summary['pages_used_after_drain']}")
        print(f"  shed={summary['shed']} "
              f"engine_restarts={summary['engine_restarts']} "
              f"replayed={summary['requests_replayed']} "
              f"drain_handoffs={summary['drain_handoffs']} "
              f"breaker_trips={summary['breaker_trips']}")
        if summary["disagg"]:
            print(f"  disagg={summary['disagg']} "
                  f"disagg_ttft_ms={summary['disagg_ttft_ms']} "
                  f"kv_handoff_ms={summary['kv_handoff_ms']} "
                  f"handoffs={summary['pool_handoffs']} "
                  f"pages_exported={summary['kv_pages_exported']} "
                  f"adopted={summary['kv_pages_adopted']} "
                  f"reused={summary['kv_pages_reused']} "
                  f"leaked={summary['disagg_pages_leaked']}")
    return summary


def main(argv=None) -> Dict[str, Any]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
