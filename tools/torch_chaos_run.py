"""Chaos smoke tool: the port of ``tools/chaos_run.py``. Train a
two-worker in-process fleet under injected faults and assert the loss
trajectory matches the fault-free run.

The fleet is the IN-PROCESS transport (``tepdist_tpu_torch/rpc/inproc.py``):
real ``TepdistServicer`` instances behind ``inproc:<port>`` addresses, so
the whole client/server robustness stack (retry/backoff, idempotency
dedup, AbortStep fencing, same-step re-execution) runs as over gRPC,
without sockets or subprocesses. The session is built FAULT-FREE, the
fault plan (``TEPDIST_FAULT_SPEC`` grammar, ``runtime/faults.py``) is
armed for the training steps, and the result is compared with a clean
baseline bit for bit. Exit code 0 = an identical trajectory and no
checkpoint rollback; the fault/retry counters are printed either way.

``--serve``: the SERVING chaos mode. The same two-worker fleet runs the
continuous-batching service; a fixed greedy request mix (the JAX tool's,
drawn from ``np.random.RandomState(1234)``) is generated under injected
serving faults (``engine_crash``/``serve_fault`` kill an engine
mid-decode; the ``ServingSupervisor`` rebuilds and replays), and the
tokens are compared bit for bit with the fault-free run.

``--kill-worker STEP``: the elastic arm. One worker of an ELASTIC session
dies after STEP steps; the session must finish on the reshaped fleet
through exactly one live migration (no checkpoint rollback) with the
trajectory of an undisturbed local run, and the ``migration_stall_ms=``
line is printed. The reference SIGKILLs a gRPC worker subprocess; here
the worker is in-process and dies the way a killed process looks to its
peers: its address stops answering (unregistered). So the arm runs where
there is no ``grpcio``, as on the card's machine.

``--kill-master STEP``: the control-plane arm. The MASTER runs as a real
subprocess journaling to a durable WAL while real gRPC worker
subprocesses (``python -m tepdist_tpu_torch.rpc.server --device cpu``)
keep running; the tool SIGKILLs the master once STEP steps have landed,
starts a fresh master that ``readopt()``s the live fleet from the WAL and
finishes the run without re-shipping weights. Asserts the merged loss
trajectory matches the undisturbed reference with any overlapping steps
bit-identical (exactly once), one takeover, no rollback, and prints
``master_recover_ms=``. It needs ``grpcio`` and runs on the CPU only: the
card's machine has no ``grpcio``.

Every arm runs on ``--device`` (the card unless ``--device cpu``).

    python tools/torch_chaos_run.py --device cpu
    python tools/torch_chaos_run.py --steps 20 --spec 'rpc_drop:p=0.3,seed=1'
    python tools/torch_chaos_run.py --serve --requests 10 \\
        --spec 'engine_crash:step=3,ti=0;serve_fault:op=decode,step=6,ti=1'
    python tools/torch_chaos_run.py --steps 6 --kill-worker 3
    python tools/torch_chaos_run.py --steps 8 --kill-master 3 --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np                               # noqa: E402
import torch                                     # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_case(stages: int, micro: int, device="cpu"):
    """(loss_fn, params, x, y): a tanh MLP of 2 * stages 16x16 layers,
    weights normal * 0.3 and a [4 * micro, 16] batch, drawn from a
    ``torch.Generator`` seeded with 0 (the JAX tool draws threefry)."""
    def loss_fn(params, x, y):
        h = x
        for i in range(2 * stages):
            h = torch.tanh(h @ params[f"w{i}"])
        return ((h - y) ** 2).mean()

    gen = torch.Generator().manual_seed(0)
    params = {f"w{i}": (torch.randn((16, 16), generator=gen) * 0.3
                        ).to(device)
              for i in range(2 * stages)}
    x = torch.randn((4 * micro, 16), generator=gen).to(device)
    y = torch.randn((4 * micro, 16), generator=gen).to(device)
    return loss_fn, params, x, y


def _case(args, params=None, batch=None):
    loss_fn, p0, x0, y0 = _build_case(args.stages, args.micro, args.device)
    if params is not None:
        p0 = {k: v.to(args.device) for k, v in params.items()}
        x0, y0 = (t.to(args.device) for t in batch)
    return loss_fn, p0, x0, y0


def run_fleet(args, steps: int, spec=None, params=None, batch=None):
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime import faults
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession,
    )

    loss_fn, params, x, y = _case(args, params, batch)
    prog = plan_pipeline(loss_fn, args.stages, args.micro, params, x, y)
    cluster, _ = make_inproc_cluster(args.stages, devices=[args.device])
    sess = DistributedPipelineSession(prog, cluster, optimizer=sgd(1e-2))
    try:
        sess.load_variables(params)
        sess.health.interval = 0.5
        if spec:
            faults.configure(spec)
        return [sess.step(x, y) for _ in range(steps)]
    finally:
        faults.configure(None)
        sess.close()
        close_inproc_cluster(cluster)


def run_serve(requests: int, workers: int, slots: int, spec=None,
              device="cpu", params=None):
    """One serving pass: the fixed request mix; returns [(request index,
    status, tokens)] and leaves counters in the registry."""
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.rpc.client import TepdistClient
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime import faults
    from tepdist_tpu_torch.serving import ServeClient

    cfg = gpt2.CONFIGS["test"]
    if params is None:
        params = gpt2.init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(1234)
    prompts = [rng.randint(1, cfg.vocab_size,
                           size=int(rng.randint(3, 12))).astype(np.int32)
               for _ in range(requests)]
    cluster, servicers = make_inproc_cluster(workers, devices=[device])
    sc = ServeClient(clients=[TepdistClient(w.address)
                              for w in cluster.workers])
    try:
        sc.load(params, cfg, slots=slots, max_len=32, name="chaos")
        if spec:
            faults.configure(spec)
        rids = [sc.submit(p, max_new_tokens=6)["request_id"]
                for p in prompts]
        results = sc.wait(rids, timeout_s=300)
        return [(i, results[r]["status"],
                 tuple(int(t) for t in results[r].get("tokens", ())))
                for i, r in enumerate(rids)]
    finally:
        faults.configure(None)
        for s in servicers:
            s.close_servables()
        close_inproc_cluster(cluster)


def _reference(prog, tx, params, x, y, steps):
    """The undisturbed trajectory: the program's sequential step, local."""
    from tepdist_tpu_torch.core.tree import tree_map

    def apply_fn(pp, ss, g):
        return pp, tx.apply(pp, g, ss)

    ref_step = prog.reference_step(apply_fn)
    p = tree_map(lambda t: t.clone(), params)
    s = tx.init(p)
    out = []
    for _ in range(steps):
        loss, p, s = ref_step(p, s, x, y)
        out.append(float(loss))
    return out


def kill_worker_chaos(args, params=None, batch=None) -> dict:
    """The elastic arm (see the module docstring): an in-process worker
    dies mid-run; exactly one LIVE migration, no checkpoint rollback, and
    the trajectory of the undisturbed local reference."""
    import shutil
    import tempfile

    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession,
    )
    from tepdist_tpu_torch.telemetry import metrics

    kill_step = args.kill_worker
    if not 0 < kill_step < args.steps:
        print(f"FAIL: --kill-worker {kill_step} must fall strictly inside "
              f"the run (0 < STEP < --steps {args.steps})")
        return {"ok": False}
    loss_fn, params, x, y = _case(args, params, batch)
    prog = plan_pipeline(loss_fn, args.stages, args.micro, params, x, y)
    tx = adam(1e-2)   # stateful: moments must survive the move
    baseline = _reference(prog, tx, params, x, y, args.steps)

    ckpt_dir = tempfile.mkdtemp(prefix="tepdist_chaos_ckpt_")
    old_ckpt = os.environ.get("TEPDIST_CKPT_DIR")
    os.environ["TEPDIST_CKPT_DIR"] = ckpt_dir   # migration's fallback
    cluster, _ = inproc.make_inproc_cluster(args.stages,
                                            devices=[args.device])
    metrics().reset()
    mig = None
    try:
        print(f"chaos: {args.stages} in-process workers up; worker "
              f"{args.stages - 1} dies after step {kill_step}")
        sess = DistributedPipelineSession(prog, cluster, optimizer=tx,
                                          elastic=True, autosave_every=1)
        try:
            sess.health.interval = 0.5
            sess.load_variables(params)
            losses = []
            for i in range(args.steps):
                if i == kill_step:
                    inproc.unregister_servicer(cluster.workers[-1].address)
                losses.append(sess.step(x, y))
            survivors = sess.cluster.num_workers
            mig = sess.last_migration
        finally:
            sess.close()
    finally:
        inproc.close_inproc_cluster(cluster)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        if old_ckpt is None:
            os.environ.pop("TEPDIST_CKPT_DIR", None)
        else:
            os.environ["TEPDIST_CKPT_DIR"] = old_ckpt

    snap = metrics().snapshot()
    counters = snap["counters"]
    print("elastic migration counters:")
    for k in sorted(counters):
        if k.split(":")[0] in ("elastic_migrations", "elastic_redispatch",
                               "checkpoint_rollback_steps", "step_retries",
                               "shards_adopted", "migrations_started",
                               "migrations_stalled", "migrations_failed"):
            print(f"  {k:<32} {counters[k]}")
    stall = snap["gauges"].get("migration_stall_ms")
    if stall is not None:
        print(f"migration_stall_ms={stall:.3f}")

    ok = True
    if survivors != args.stages - 1:
        ok = False
        print(f"FAIL: expected the reshaped fleet to hold "
              f"{args.stages - 1} workers, found {survivors}")
    if counters.get("elastic_migrations", 0) != 1:
        ok = False
        print(f"FAIL: expected exactly 1 live migration, counted "
              f"{counters.get('elastic_migrations', 0)} "
              f"(redispatch fallback: "
              f"{counters.get('elastic_redispatch', 0)})")
    if counters.get("checkpoint_rollback_steps"):
        ok = False
        print("FAIL: live migration must not roll back to a checkpoint")
    if not np.allclose(losses, baseline, rtol=1e-4):
        ok = False
        print("FAIL: loss trajectory diverged from the undisturbed run")
        for i, (a, b) in enumerate(zip(baseline, losses)):
            mark = "" if np.isclose(a, b, rtol=1e-4) else "   <-- diverged"
            print(f"  step {i}: clean={a!r} chaos={b!r}{mark}")
    else:
        print(f"loss trajectory matches the undisturbed run over "
              f"{args.steps} steps through the migration "
              f"(final loss {losses[-1]:.6f}"
              + (f", stall {mig['stall_ms']:.0f} ms" if mig else "")
              + ")")
    print("PASS" if ok else "FAIL")
    return {"ok": ok, "losses": losses, "baseline": baseline,
            "survivors": survivors, "migration_stall_ms": stall,
            "counters": {k: counters[k] for k in counters
                         if k.split(":")[0] in (
                             "elastic_migrations", "elastic_redispatch",
                             "checkpoint_rollback_steps", "step_retries",
                             "shards_adopted")}}


def _master_phase(args) -> int:
    """Hidden subcommand: the MASTER subprocess of the --kill-master arm
    (``tools/chaos_run.py``'s ``_master_phase``): phase=run builds the
    session against the running fleet, journals to --wal-dir and appends
    one fsync'd JSONL loss line a step (the WAL is flushed AFTER the line,
    so a kill in the window re-runs at most the last step, served from
    the workers' caches); phase=resume ``readopt()``s the fleet from the
    WAL and finishes the run, printing the takeover lines."""
    import json

    from tepdist_tpu_torch.core.cluster_spec import ClusterSpec, WorkerSpec
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession,
    )
    from tepdist_tpu_torch.telemetry import metrics

    loss_fn, params, x, y = _build_case(args.stages, args.micro)
    if args.case:
        case = torch.load(args.case)
        params, x, y = case["params"], case["x"], case["y"]
    prog = plan_pipeline(loss_fn, args.stages, args.micro, params, x, y)
    tx = adam(1e-2)   # stateful: moments must survive the takeover
    ports = [int(p) for p in args.ports.split(",")]
    cluster = ClusterSpec([
        WorkerSpec("127.0.0.1", port, [0], task_index=ti)
        for ti, port in enumerate(ports)])

    if args.master_phase == "run":
        sess = DistributedPipelineSession(
            prog, cluster, optimizer=tx, wal_dir=args.wal_dir,
            elastic=True, autosave_every=1)
        sess.health.interval = 0.5
        sess.load_variables(params)
        start = 0
    else:
        sess = DistributedPipelineSession.readopt(
            prog, cluster, params, optimizer=tx, wal_dir=args.wal_dir,
            elastic=True, autosave_every=1)
        sess.health.interval = 0.5
        start = sess._step
        print(f"master_recover_ms={sess.last_recover_ms:.3f}", flush=True)
        print(f"resumed_at={start} epoch={sess._epoch} "
              f"plan_gen={sess._plan_gen}", flush=True)

    with open(args.loss_file, "a") as f:
        for i in range(start, args.steps):
            loss = sess.step(x, y)
            f.write(json.dumps({"step": i, "loss": float(loss),
                                "phase": args.master_phase}) + "\n")
            f.flush()
            os.fsync(f.fileno())
            if sess._wal is not None:
                sess._wal.flush()

    if args.master_phase == "resume":
        counters = metrics().snapshot()["counters"]
        print(f"master_takeovers={counters.get('master_takeovers', 0)}",
              flush=True)
        print("checkpoint_rollback_steps="
              f"{counters.get('checkpoint_rollback_steps', 0)}",
              flush=True)
    sess.close()
    return 0


def kill_master_chaos(args, params=None, batch=None) -> dict:
    """The control-plane arm (see the module docstring)."""
    import json
    import shutil
    import signal
    import socket
    import subprocess
    import tempfile
    import time as _time

    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc.client import TepdistClient

    kill_step = args.kill_master
    if not 0 < kill_step < args.steps:
        print(f"FAIL: --kill-master {kill_step} must fall strictly inside "
              f"the run (0 < STEP < --steps {args.steps})")
        return {"ok": False}
    if torch.device(args.device).type != "cpu":
        print("FAIL: --kill-master runs gRPC worker and master "
              "subprocesses on the CPU: pass --device cpu")
        return {"ok": False}
    loss_fn, params, x, y = _case(args, params, batch)
    prog = plan_pipeline(loss_fn, args.stages, args.micro, params, x, y)
    baseline = _reference(prog, adam(1e-2), params, x, y, args.steps)

    def free_port():
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            return sk.getsockname()[1]

    tmp = tempfile.mkdtemp(prefix="tepdist_chaos_master_")
    wal_dir = os.path.join(tmp, "wal")
    loss_file = os.path.join(tmp, "losses.jsonl")
    case_file = os.path.join(tmp, "case.pt")
    torch.save({"params": params, "x": x, "y": y}, case_file)
    open(loss_file, "w").close()
    env = dict(os.environ)
    env["TEPDIST_CKPT_DIR"] = os.path.join(tmp, "ckpt")  # fallback ladder
    me = os.path.abspath(__file__)
    ports = [free_port() for _ in range(args.stages)]
    workers = [subprocess.Popen(
        [sys.executable, "-m", "tepdist_tpu_torch.rpc.server",
         "--port", str(port), "--device", "cpu", "--task_index", str(ti)],
        env=env, cwd=ROOT,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for ti, port in enumerate(ports)]

    def master_cmd(phase):
        return [sys.executable, me, "--master-phase", phase,
                "--ports", ",".join(str(p_) for p_ in ports),
                "--wal-dir", wal_dir, "--loss-file", loss_file,
                "--case", case_file, "--steps", str(args.steps),
                "--stages", str(args.stages), "--micro", str(args.micro),
                "--device", "cpu"]

    master = None
    resume_out = ""
    try:
        for port in ports:
            c = TepdistClient(f"127.0.0.1:{port}")
            c.wait_ready(60)
            c.close()
        run_log = open(os.path.join(tmp, "master_run.log"), "wb")
        master = subprocess.Popen(master_cmd("run"), env=env, cwd=ROOT,
                                  stdout=run_log, stderr=run_log)
        print(f"chaos: master subprocess journaling to WAL; SIGKILL "
              f"lands after step {kill_step} of {args.steps}")
        deadline = _time.monotonic() + 300
        while _time.monotonic() < deadline:
            if master.poll() is not None:
                print(f"FAIL: master exited rc={master.returncode} before "
                      f"the kill (see {tmp}/master_run.log)")
                return {"ok": False}
            with open(loss_file) as f:
                done = sum(1 for _ in f)
            if done >= kill_step:
                break
            _time.sleep(0.005)
        else:
            print("FAIL: master never reached the kill step in 300 s")
            return {"ok": False}
        master.send_signal(signal.SIGKILL)
        master.wait()
        with open(loss_file) as f:
            run_lines = [json.loads(ln) for ln in f if ln.strip()]
        print(f"chaos: master killed with {len(run_lines)} step(s) "
              f"journaled; restarting master from the WAL")

        t0 = _time.monotonic()
        resume = subprocess.run(master_cmd("resume"), env=env, cwd=ROOT,
                                capture_output=True, text=True,
                                timeout=300)
        wall_ms = (_time.monotonic() - t0) * 1e3
        resume_out = resume.stdout
        if resume.returncode != 0:
            print(f"FAIL: resume master exited rc={resume.returncode}\n"
                  f"{resume.stdout}\n{resume.stderr}")
            return {"ok": False}
        with open(loss_file) as f:
            all_lines = [json.loads(ln) for ln in f if ln.strip()]
    finally:
        if master is not None and master.poll() is None:
            master.send_signal(signal.SIGKILL)
            master.wait()
        for pr in workers:
            pr.send_signal(signal.SIGKILL)
            pr.wait()

    kv = {}
    for ln in resume_out.splitlines():
        if "=" in ln and " " not in ln.split("=", 1)[0]:
            for tok in ln.split():
                if "=" in tok:
                    k, _, v = tok.partition("=")
                    kv[k] = v
    ok = True

    # Exactly once: every step one loss; an overlapping re-run (the
    # resume re-serving the last journaled step from the workers' caches)
    # must be BIT-identical or the takeover applied an update twice.
    by_step = {}
    for ln in all_lines:
        st, lv = ln["step"], ln["loss"]
        if st in by_step and by_step[st] != lv:
            ok = False
            print(f"FAIL: step {st} re-ran non-identically across the "
                  f"takeover: {by_step[st]!r} vs {lv!r}")
        by_step[st] = lv
    missing = [i for i in range(args.steps) if i not in by_step]
    if missing:
        ok = False
        print(f"FAIL: steps never executed across both masters: {missing}")
    overlap = len(all_lines) - len(by_step)

    resumed_at = int(kv.get("resumed_at", -1))
    if not 0 < resumed_at < args.steps:
        ok = False
        print(f"FAIL: resume master started at step {resumed_at}; the "
              f"takeover either lost the watermark or had nothing to do")
    if kv.get("master_takeovers") != "1":
        ok = False
        print(f"FAIL: expected exactly 1 takeover, counted "
              f"{kv.get('master_takeovers')}")
    if kv.get("checkpoint_rollback_steps", "0") != "0":
        ok = False
        print("FAIL: re-adoption must not roll back to a checkpoint")

    merged = [by_step[i] for i in range(args.steps) if i in by_step]
    if not missing and not np.allclose(merged, baseline, rtol=1e-4):
        ok = False
        print("FAIL: merged loss trajectory diverged from the "
              "undisturbed run")
        for i, (a, b) in enumerate(zip(baseline, merged)):
            mark = "" if np.isclose(a, b, rtol=1e-4) else "   <-- diverged"
            print(f"  step {i}: clean={a!r} chaos={b!r}{mark}")
    elif not missing:
        print(f"loss trajectory matches the undisturbed run over "
              f"{args.steps} steps through the takeover (resumed at "
              f"step {resumed_at}, {overlap} cached re-run(s), final "
              f"loss {merged[-1]:.6f})")
    if "master_recover_ms" in kv:
        print(f"master_recover_ms={float(kv['master_recover_ms']):.3f}")
    else:
        ok = False
        print("FAIL: resume master never printed master_recover_ms")
    print(f"takeover wall (subprocess spawn to fleet resumed): "
          f"{wall_ms:.0f} ms")
    shutil.rmtree(tmp, ignore_errors=True)
    print("PASS" if ok else "FAIL")
    return {"ok": ok, "losses": merged, "baseline": baseline,
            "resumed_at": resumed_at, "overlap": overlap,
            "master_takeovers": kv.get("master_takeovers"),
            "checkpoint_rollback_steps": kv.get("checkpoint_rollback_steps"),
            "master_recover_ms": kv.get("master_recover_ms")}


def serve_chaos(args, params=None) -> dict:
    from tepdist_tpu_torch.telemetry import metrics

    print(f"serve baseline: {args.requests} fault-free requests "
          f"({args.stages} workers, {args.slots} slots)")
    baseline = run_serve(args.requests, args.stages, args.slots,
                         device=args.device, params=params)
    metrics().reset()
    print(f"serve chaos:    same mix under {args.spec!r}")
    chaotic = run_serve(args.requests, args.stages, args.slots,
                        spec=args.spec, device=args.device, params=params)

    counters = metrics().snapshot()["counters"]
    print("serving recovery counters:")
    for k in sorted(counters):
        if (k.split(":")[0] in ("fault_injected", "rpc_retries",
                                "engine_restarts", "requests_replayed",
                                "drain_handoffs", "serve_shed",
                                "serve_breaker_trips")
                or k in ("serve_requests_deduped",
                         "serve_requests_failed")):
            print(f"  {k:<32} {counters[k]}")

    ok = True
    if any(s != "done" for _, s, _ in chaotic):
        ok = False
        print(f"FAIL: non-done terminal states under chaos: "
              f"{[(i, s) for i, s, _ in chaotic if s != 'done']}")
    if chaotic != baseline:
        ok = False
        print("FAIL: generated tokens diverged under chaos")
        for (i, sa, ta), (_, sb, tb) in zip(baseline, chaotic):
            if (sa, ta) != (sb, tb):
                print(f"  req {i}: clean={sa}:{ta} chaos={sb}:{tb}")
    else:
        print(f"{args.requests} requests bit-identical across "
              f"{counters.get('engine_restarts', 0)} engine restart(s), "
              f"{counters.get('requests_replayed', 0)} replay(s)")
    if args.spec and not counters.get("fault_injected"):
        print("WARN: fault plan never fired (spec too mild for this run)")
    print("PASS" if ok else "FAIL")
    return {"ok": ok, "baseline": baseline, "chaos": chaotic,
            "engine_restarts": counters.get("engine_restarts", 0),
            "requests_replayed": counters.get("requests_replayed", 0),
            "fault_injected": counters.get("fault_injected", 0)}


def fleet_chaos(args, params=None, batch=None) -> dict:
    from tepdist_tpu_torch.telemetry import metrics

    print(f"baseline: {args.steps} fault-free steps "
          f"({args.stages} workers, {args.micro} micro-batches)")
    baseline = run_fleet(args, args.steps, params=params, batch=batch)
    metrics().reset()
    print(f"chaos:    same run under {args.spec!r}")
    chaotic = run_fleet(args, args.steps, spec=args.spec, params=params,
                        batch=batch)

    counters = metrics().snapshot()["counters"]
    print("fault/recovery counters:")
    for k in sorted(counters):
        if k.split(":")[0] in ("fault_injected", "rpc_retries",
                               "step_retries", "dedup_hits",
                               "worker_revived", "elastic_redispatch",
                               "checkpoint_rollback_steps"):
            print(f"  {k:<32} {counters[k]}")

    ok = True
    if chaotic != baseline:
        ok = False
        print("FAIL: loss trajectory diverged under chaos")
        for i, (a, b) in enumerate(zip(baseline, chaotic)):
            mark = "" if a == b else "   <-- diverged"
            print(f"  step {i}: clean={a!r} chaos={b!r}{mark}")
    else:
        print(f"loss trajectory identical over {args.steps} steps "
              f"(final loss {chaotic[-1]:.6f})")
    if counters.get("checkpoint_rollback_steps"):
        ok = False
        print("FAIL: chaos run rolled back to a checkpoint")
    if args.spec and not counters.get("fault_injected"):
        print("WARN: fault plan never fired (spec too mild for this run)")
    print("PASS" if ok else "FAIL")
    return {"ok": ok, "baseline": baseline, "chaos": chaotic,
            "fault_injected": counters.get("fault_injected", 0),
            "rpc_retries": sum(v for k, v in counters.items()
                               if k.split(":")[0] == "rpc_retries")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser("torch_chaos_run")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--stages", type=int, default=2,
                    help="pipeline stages = in-process workers")
    ap.add_argument("--micro", type=int, default=2,
                    help="micro-batches per step")
    ap.add_argument("--spec", default=None,
                    help="TEPDIST_FAULT_SPEC grammar (runtime/faults.py)")
    ap.add_argument("--serve", action="store_true",
                    help="serving chaos mode: engine-crash recovery + "
                         "token bit-identity instead of training steps")
    ap.add_argument("--requests", type=int, default=10,
                    help="(--serve) request count")
    ap.add_argument("--slots", type=int, default=2,
                    help="(--serve) KV-cache slots per worker")
    ap.add_argument("--kill-worker", type=int, default=None, metavar="STEP",
                    help="elastic arm: a worker dies after STEP steps; "
                         "assert completion on the reshaped fleet via one "
                         "LIVE migration")
    ap.add_argument("--kill-master", type=int, default=None, metavar="STEP",
                    help="control-plane arm: SIGKILL the real master "
                         "subprocess after STEP steps and assert a fresh "
                         "master re-adopts the live fleet from the WAL "
                         "bit-exactly (gRPC, --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="the workers' device: cuda (the card, the "
                         "default) or cpu")
    # Hidden plumbing for the --kill-master subprocess phases.
    ap.add_argument("--master-phase", choices=("run", "resume"),
                    default=None, help=argparse.SUPPRESS)
    ap.add_argument("--ports", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wal-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--loss-file", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--case", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def run(args, params=None, batch=None) -> dict:
    """The arm ``args`` names; ``params`` and ``batch`` ((x, y), or for
    ``--serve`` the GPT-2 ``test`` weights in ``params``) replace the
    seeded case. Returns what it printed, with ``ok``."""
    if args.kill_master is not None:
        return kill_master_chaos(args, params, batch)
    if args.kill_worker is not None:
        return kill_worker_chaos(args, params, batch)
    if args.serve:
        if args.spec is None:
            args.spec = ("engine_crash:step=3,ti=0;"
                         "serve_fault:op=decode,step=6,ti=1,seed=7")
        return serve_chaos(args, params)
    if args.spec is None:
        args.spec = "rpc_drop:p=0.2,seed=7"
    return fleet_chaos(args, params, batch)


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    _args = parse_args()
    if _args.master_phase is not None:
        sys.exit(_master_phase(_args))
    sys.exit(0 if run(_args)["ok"] else 1)
