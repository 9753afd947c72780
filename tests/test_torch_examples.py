"""The port's training examples (``examples_torch/``) held to the JAX
package's (``examples/``) at the argument lines of
``scripts/run_examples.sh``, on the CPU.

Each JAX example runs in this process (``runpy`` with a patched
``sys.argv``, so it plans over the pytest process's 8 virtual CPU
devices) and its printed losses are parsed. The reference's initial
arrays are computed here as the example computes them
(``init_params(cfg, PRNGKey(0))``, ``fake_batch``, the ``PRNGKey(1)``
tokens, ...), carried across by ``convert.to_torch`` and handed to the
port's ``run(args, params, batch)`` with ``--device cpu``. The port plans
over a one-rank world (its examples plan over the process group's
ranks), so the printed mesh differs; the losses do not.

Tolerances: every example here is fp32 at its ``test`` config, so each
printed loss must agree within 2e-4 absolute (the JAX example prints 4
decimals; fp32 sums in another order, and data=8 against data=1, add
less). Plan facts: the number of stages and the sequence mesh size
equal; the stage cut equal (each stage's matmul flops equal exactly) and
each printed stage's flops within 2%: the layout nodes that
``dot_general`` absorbs cost nothing in the port either
(``graph/cost.py``'s ``fold_view_flops``), and what is left is mostly the
loss's ``logsumexp``, one aten node where the jaxpr prices its
exponentials and sums (a 1.6% shortfall on the second GPT-2 ``test``
stage, 0.6% excess on the first against the JAX example's three printed
digits; none in the matmuls).
``INTRA_STAGE_TP=2 VAR_MEM_LIMIT=6 MiB``: in both packages the example's
``PipelineExecutable`` takes no TP degree from the environment (only
``plan_training`` reads INTRA_STAGE_TP), so that line trains as the plain
pipeline does, in both.
"""

import contextlib
import io
import os
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from tepdist_tpu.core.service_env import ServiceEnv as JaxServiceEnv
from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.models import gpt_moe as jmoe
from tepdist_tpu.models import llama as jllama
from tepdist_tpu.models import wide_resnet as jwrn
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.service_env import ServiceEnv

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 2e-4
STAGE_FLOPS_RTOL = 0.02
_LOSS = re.compile(r"loss ?= ?(-?[0-9.]+)")


def _run_jax(rel: str, argv) -> str:
    """Stdout of ``examples/<rel>`` run in this process with ``argv``."""
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [rel] + list(argv)
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(ROOT, "examples", rel),
                           run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


def _run_port(module, argv, params, batch, **kw):
    """(stdout, result) of the port example's ``run`` on the CPU."""
    args = module.parse_args(list(argv) + ["--device", "cpu"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = module.run(args, params=params, batch=batch, **kw)
    return buf.getvalue(), out


def _printed_losses(text: str):
    return [float(x) for x in _LOSS.findall(text)]


def _assert_losses(jax_text, port_text, port_losses):
    want = _printed_losses(jax_text)
    assert len(_printed_losses(port_text)) == len(want), (jax_text,
                                                          port_text)
    assert want, jax_text
    np.testing.assert_allclose(port_losses, want, rtol=0, atol=LOSS_ATOL)


def _gpt2_arrays(batch, seq):
    cfg = jgpt2.CONFIGS["test"]
    params = jax.device_get(jgpt2.init_params(cfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jgpt2.fake_batch(cfg, batch, seq))
    return (convert.to_torch(params, device="cpu"),
            torch.tensor(tokens).long())


def _gpt2_port():
    from examples_torch.GPT2 import main
    return main


_GPT2_BASE = ["--config", "test", "--batch", "8", "--seq", "32",
              "--steps", "2"]


def test_gpt2_auto_plan():
    jt = _run_jax("GPT2/main.py", _GPT2_BASE)
    params, tokens = _gpt2_arrays(8, 32)
    pt, out = _run_port(_gpt2_port(), _GPT2_BASE, params, tokens)
    assert "planned in" in jt and "planned in" in pt
    assert out["topology"] == "MeshTopology(data=1)"
    _assert_losses(jt, pt, out["losses"])


def _stage_matmul_flops(prog, matmul):
    flops = [0.0] * prog.num_stages
    for n in prog.graph.nodes:
        s = prog.decomp.assignment[n.id]
        if s >= 0 and matmul(n):
            flops[s] += n.flops
    return flops


@pytest.mark.parametrize("env", [None, {"INTRA_STAGE_TP": "2",
                                        "VAR_MEM_LIMIT": str(6 << 20)}],
                         ids=["plain", "intra_stage_tp_env"])
def test_gpt2_pipeline(env, monkeypatch):
    from tepdist_tpu.parallel import pipeline as jpipe
    from tepdist_tpu_torch.parallel import pipeline as tpipe

    argv = _GPT2_BASE + ["--num_stages", "2", "--num_micro_batches", "2"]
    progs = {}
    for name, mod in (("jax", jpipe), ("port", tpipe)):
        plan = mod.plan_pipeline

        def keep(*a, _plan=plan, _name=name, **k):
            progs[_name] = _plan(*a, **k)
            return progs[_name]
        monkeypatch.setattr(mod, "plan_pipeline", keep)
    if env:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        JaxServiceEnv.reset(env)
        ServiceEnv.reset(env)
    try:
        jt = _run_jax("GPT2/main.py", argv)
        params, tokens = _gpt2_arrays(8, 32)
        pt, out = _run_port(_gpt2_port(), argv, params, tokens)
    finally:
        JaxServiceEnv.reset()
        ServiceEnv.reset()
    _assert_losses(jt, pt, out["losses"])
    want = [float(f) for f in re.search(r"flops=\[([^\]]*)\]", jt)
            .group(1).replace("'", "").split(",")]
    assert out["num_stages"] == len(want) == 2
    np.testing.assert_allclose(out["stage_flops"], want,
                               rtol=STAGE_FLOPS_RTOL)
    jm = _stage_matmul_flops(progs["jax"],
                             lambda n: n.prim == "dot_general")
    tm = _stage_matmul_flops(progs["port"], lambda n: str(n.target) in (
        "aten.mm.default", "aten.bmm.default", "aten.addmm.default",
        "aten.baddbmm.default"))
    assert jm == tm, (jm, tm)


def test_gpt2_collective_pipeline():
    argv = _GPT2_BASE + ["--num_stages", "2", "--num_micro_batches", "2",
                         "--pipeline", "collective"]
    jt = _run_jax("GPT2/main.py", argv)
    params, tokens = _gpt2_arrays(8, 32)
    pt, out = _run_port(_gpt2_port(), argv, params, tokens)
    assert re.search(r"S=2 M=2", jt) and re.search(r"S=2 M=2", pt)
    _assert_losses(jt, pt, [out["first_loss"]] + out["losses"])


@pytest.mark.parametrize("impl,mesh", [("ring", 8), ("ulysses", 4)])
def test_long_context(impl, mesh):
    from examples_torch.GPT2 import long_context

    argv = ["--config", "test", "--batch", "2", "--seq", "64", "--steps",
            "2", "--impl", impl]
    jt = _run_jax("GPT2/long_context.py", argv)
    assert f"sequence mesh: {mesh} devices" in jt
    params, tokens = _gpt2_arrays(2, 64)
    pt, out = _run_port(long_context, argv, params, tokens,
                        devices=["cpu"] * 8)
    assert out["seq_mesh"] == mesh
    assert f"sequence mesh: {mesh} devices" in pt
    _assert_losses(jt, pt, [out["first_loss"]] + out["losses"])


def test_wide_resnet():
    from examples_torch.wide_resnet import train_imagenet

    argv = ["--model_type", "-1", "--batch", "16", "--image_size", "32",
            "--steps", "2"]
    jt = _run_jax("wide_resnet/train_imagenet.py", argv)
    cfg = jwrn.CONFIGS[-1]
    params = jax.device_get(jwrn.init_params(cfg, jax.random.PRNGKey(0)))
    images, labels = jwrn.fake_batch(cfg, 16, 32)
    pt, out = _run_port(
        train_imagenet, argv, convert.to_torch(params, device="cpu"),
        (torch.tensor(np.asarray(images)),
         torch.tensor(np.asarray(labels)).long()))
    _assert_losses(jt, pt, out["losses"])


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_llama(attn):
    """``--attn flash`` runs the JAX Pallas kernels in interpret mode and
    the port's kernels' plain versions (the CPU)."""
    import dataclasses

    from examples_torch.llama import train

    argv = ["--config", "test", "--batch", "4", "--seq", "32", "--steps",
            "2", "--attn", attn]
    jt = _run_jax("llama/train.py", argv)
    cfg = dataclasses.replace(jllama.CONFIGS["test"], attn=attn)
    params = jax.device_get(jllama.init_params(cfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 33),
                                           0, cfg.vocab_size))
    pt, out = _run_port(train, argv, convert.to_torch(params, device="cpu"),
                        torch.tensor(tokens).long())
    assert f"attn={attn}" in jt and f"attn={attn}" in pt
    _assert_losses(jt, pt, out["losses"])


def test_gpt_moe():
    from examples_torch.gpt_moe import pretrain_gpt_moe

    argv = ["--config", "test", "--batch", "4", "--seq", "32", "--steps",
            "2"]
    jt = _run_jax("gpt_moe/pretrain_gpt_moe.py", argv)
    cfg = jmoe.CONFIGS["test"]
    params = jax.device_get(jmoe.init_params(cfg, jax.random.PRNGKey(0)))
    tokens = np.asarray(jgpt2.fake_batch(cfg.base, 4, 32))
    pt, out = _run_port(pretrain_gpt_moe, argv,
                        convert.to_torch(params, device="cpu"),
                        torch.tensor(tokens).long())
    pinned = int(re.search(r"(\d+) expert weights pinned", jt).group(1))
    assert out["pinned"] == pinned
    _assert_losses(jt, pt, out["losses"])


@pytest.mark.parametrize("name", ["attention", "conv"])
def test_smoke_testing_auto_plan(name):
    """``smoke_testing/attention.py`` and ``conv.py``: 5 SGD steps on the
    planned gradient (6 decimals printed: atol 2e-4 holds with room)."""
    import importlib

    import jax.numpy as jnp

    from tepdist_tpu.models import mlp as jmlp

    module = importlib.import_module(f"examples_torch.smoke_testing.{name}")
    jt = _run_jax(f"smoke_testing/{name}.py", [])
    k = jax.random.PRNGKey(0)
    if name == "attention":
        params = jmlp.init_attention(k, d=64, heads=4)
        x = jax.random.normal(k, (8, 32, 64))
        batch = (torch.tensor(np.asarray(x)), torch.zeros((8, 32, 64)))
    else:
        params = jmlp.init_conv(k)
        x = jax.random.normal(k, (32, 16, 16, 3))
        batch = (torch.tensor(np.asarray(x)),
                 torch.tensor(np.asarray(jnp.zeros((32,), jnp.int32))).long())
    pt, out = _run_port(module, [],
                        convert.to_torch(jax.device_get(params), device="cpu"),
                        batch)
    _assert_losses(jt, pt, out["losses"])
