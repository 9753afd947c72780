"""The port's sampler (tepdist_tpu_torch.models.sampling) on the CPU:
greedy tokens equal to the JAX package's ``sample`` on the same weights
(through the weight bridge) at the fp32 test config, and the contracts of
``tests/test_sampling.py``: greedy decoding equals the argmax of the full
forward at every step, top-k=1 equals greedy, a seeded generator is
deterministic, and the context-length guard raises. The JAX sampler draws
with threefry, whose values the port cannot match, so seeded draws are held
to these contracts, not to JAX's tokens. Exact: token ids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.models import sampling as jsampling
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.models import gpt2, sampling

torch.set_num_threads(2)

CFG = gpt2.CONFIGS["test"]
JCFG = jgpt2.CONFIGS["test"]


@pytest.fixture(scope="module")
def weights():
    jparams = jax.device_get(jgpt2.init_params(JCFG, jax.random.PRNGKey(0)))
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                           JCFG.vocab_size))
    return jparams, convert.to_torch(jparams, device="cpu"), prompt


def test_greedy_equals_the_reference(weights):
    jparams, params, prompt = weights
    want = jsampling.sample(jparams, jnp.asarray(prompt), JCFG,
                            max_new_tokens=10, greedy=True)
    got = sampling.sample(params, torch.tensor(prompt), CFG,
                          max_new_tokens=10, greedy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_decode_matches_full_forward(weights):
    _, params, prompt = weights
    out = sampling.sample(params, torch.tensor(prompt), CFG,
                          max_new_tokens=6, greedy=True)
    toks = torch.tensor(prompt).long()
    with torch.no_grad():
        for _ in range(6):
            nxt = gpt2.forward(params, toks, CFG)[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None]], dim=1)
    assert torch.equal(out, toks)


def test_single_token_and_shapes(weights):
    _, params, prompt = weights
    out = sampling.sample(params, torch.tensor(prompt), CFG,
                          max_new_tokens=1, greedy=True)
    assert out.shape == (2, 9)
    assert torch.equal(out[:, :8], torch.tensor(prompt).long())


def test_topk_restricts_support(weights):
    _, params, prompt = weights
    g = sampling.sample(params, torch.tensor(prompt), CFG, max_new_tokens=5,
                        greedy=True)
    k1 = sampling.sample(params, torch.tensor(prompt), CFG,
                         max_new_tokens=5, temperature=5.0, top_k=1,
                         generator=torch.Generator().manual_seed(7))
    assert torch.equal(g, k1)
    k3 = sampling.sample(params, torch.tensor(prompt), CFG,
                         max_new_tokens=1, temperature=5.0, top_k=3,
                         generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        logits = gpt2.forward(params, torch.tensor(prompt).long(), CFG)
    top3 = torch.topk(logits[:, -1], 3).indices
    assert all(int(k3[b, -1]) in top3[b].tolist() for b in range(2))


def test_sampling_is_seed_deterministic(weights):
    _, params, prompt = weights

    def draw(seed):
        return sampling.sample(params, torch.tensor(prompt), CFG,
                               max_new_tokens=5, temperature=1.0,
                               generator=torch.Generator().manual_seed(seed))

    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))


def test_context_length_guard(weights):
    _, params, _ = weights
    prompt = torch.zeros((2, 60), dtype=torch.long)
    with pytest.raises(ValueError, match="n_ctx"):
        sampling.sample(params, prompt, CFG, max_new_tokens=10,
                        greedy=True)
