"""Sampling through the service on server-held trained weights: the port
of ``examples/GPT2/generate.py`` (reference: examples/GPT2/predict_fns.py
and models/gpt2/sample.py: ``sample_sequence`` with temperature/top-k on
the trained weights; nothing is fetched to the client).

A few training steps over RPC, then ``compile_generate``/``generate``
ship ONE decode program (``models/sampling.sample``: a static KV cache, a
loop over the new tokens, greedy or multinomial) that reads the server's
variable store. ``--local`` spawns ``python -m tepdist_tpu_torch.rpc.server``
on ``--device``; otherwise the server is ``SERVER_IP:SERVER_PORT``
(``SERVER_IP=inproc`` names an in-process servicer at
``inproc:SERVER_PORT``).

    python examples_torch/GPT2/generate.py --local --config test \\
        --steps 3 --max_new_tokens 16 --temperature 0.8 --top_k 40
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(
    _os.path.dirname(_os.path.abspath(__file__)), "..", "..")))

import argparse
import signal

from examples_torch import common
from examples_torch.smoke_testing.simple import (server_address,
                                                 spawn_local_server)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--local", action="store_true")
    ap.add_argument("--config", default="test")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--prompt_len", type=int, default=8)
    ap.add_argument("--max_new_tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--greedy", action="store_true")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def run(args, params=None, batch=None):
    """Train and sample; ``params`` defaults to the port's seeded init and
    ``batch`` ((tokens, prompt)) to its fake batches. Returns the losses
    and the generated rows."""
    from tepdist_tpu_torch.client.session import TepdistSession
    from tepdist_tpu_torch.models import gpt2, sampling
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.train import value_and_grad

    proc = None
    if args.local:
        proc, port = spawn_local_server(args.device)
        address = f"127.0.0.1:{port}"
    else:
        address = server_address()

    cfg = gpt2.CONFIGS[args.config]
    if params is None:
        params = gpt2.init_params(cfg, seed=0, device="cpu")
    if batch is None:
        tokens = gpt2.fake_batch(cfg, args.batch, args.seq, device="cpu")
        prompt = gpt2.fake_batch(cfg, 2, args.prompt_len + 1,
                                 device="cpu")[:, :args.prompt_len]
    else:
        tokens, prompt = batch
    tx = adam(1e-3)
    grad_fn = value_and_grad(lambda p, t: gpt2.loss_fn(p, t, cfg))

    def step(params, opt_state, tokens):
        loss, grads = grad_fn(params, tokens)
        return loss, params, tx.apply(params, grads, opt_state)

    losses, rows = [], []
    try:
        sess = TepdistSession(address)
        sess.client.wait_ready(timeout=120)
        sess.compile_train_step(step, params, tx.init(params), tokens)
        for i in range(args.steps):
            losses.append(sess.run(tokens))
            print(f"step {i}: loss={losses[-1]:.4f}", flush=True)

        def gen_fn(p, prompt):
            return sampling.sample(
                p, prompt, cfg, max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, top_k=args.top_k,
                greedy=args.greedy)

        sess.compile_generate(gen_fn, params, prompt)
        out = sess.generate(prompt)
        for row in out.tolist():
            rows.append(row)
            print("generated:", " ".join(str(int(t)) for t in row),
                  flush=True)
        sess.close()
    finally:
        if proc is not None:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
    return {"losses": losses, "generated": rows}


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
