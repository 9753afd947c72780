"""The weight bridge (tepdist_tpu_torch.convert): JAX params -> port ->
numpy is bit-exact for both GPT-2 layouts, bf16 included, and keeps the
JAX flat-leaf order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.models import gpt2 as tgpt2

torch.set_num_threads(2)

CFG = dataclasses.replace(jgpt2.CONFIGS["test"], dtype=jnp.bfloat16)
CFG_T = dataclasses.replace(tgpt2.CONFIGS["test"], dtype=torch.bfloat16)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("layout", ["unrolled", "stacked"])
def test_round_trip_is_bit_exact(layout):
    key = jax.random.PRNGKey(0)
    params = (jgpt2.init_params(CFG, key) if layout == "unrolled"
              else jgpt2.stacked_init_params(CFG, key))
    tparams = convert.to_torch(jax.device_get(params), device="cpu")
    ref = jax.tree_util.tree_leaves(params)
    got = tree_leaves(tparams)
    assert len(got) == len(ref)
    for t, r in zip(got, ref):
        assert t.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[str(r.dtype)]
        assert tuple(t.shape) == r.shape
    back = jax.tree_util.tree_leaves(convert.to_numpy(tparams))
    for b, r in zip(back, ref):
        assert b.dtype == r.dtype
        np.testing.assert_array_equal(_bits(b), _bits(r))


def test_stacking_agrees_across_packages():
    params = jgpt2.init_params(CFG, jax.random.PRNGKey(1))
    stacked = jgpt2.stack_block_params(params, CFG)
    mine = tgpt2.stack_block_params(
        convert.to_torch(jax.device_get(params), device="cpu"), CFG_T)
    for k in stacked:
        np.testing.assert_array_equal(
            _bits(convert.tensor_to_array(mine[k])), _bits(stacked[k]))


def test_to_torch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    params = jax.device_get(jgpt2.init_params(CFG, jax.random.PRNGKey(2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.to_torch(params)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.array_to_tensor(np.zeros(3, np.float32))
