"""The port's input pipeline (tepdist_tpu_torch.data) against the JAX
package's (tepdist_tpu.data), on the CPU: the cases of ``tests/test_data.py``
rerun on the port, the same token files and the same batches for a seed in
both packages, and errors of the source iterator raised by the prefetcher.
Exact: integer tokens, no arithmetic."""

import itertools

import numpy as np
import pytest
import torch

from tepdist_tpu import data as jdata
from tepdist_tpu_torch.data import (
    DevicePrefetcher,
    TokenDataset,
    encode_bytes,
    fake_input_iterator,
    pack_token_file,
)

torch.set_num_threads(2)


def test_pack_and_sample(tmp_path):
    toks = np.arange(10_000, dtype=np.int64) % 50257
    path = str(tmp_path / "toks.bin")
    pack_token_file(toks, path)
    ds = TokenDataset(path)
    assert len(ds) == 10_000
    batch = ds.sample(np.random.default_rng(0), batch=4, seq=128)
    assert batch.shape == (4, 129) and batch.dtype == np.int32
    for row in batch:
        np.testing.assert_array_equal(
            row, (np.arange(row[0], row[0] + 129) % 50257))


@pytest.mark.parametrize("vocab", [256, 50257, 100_000])
def test_files_and_batches_equal_the_reference(tmp_path, vocab):
    """Both packages write the same bytes and draw the same windows for a
    seed, from either package's file (uint16 and uint32 token files)."""
    toks = (np.arange(6_000, dtype=np.int64) * 7919) % vocab
    mine, ref = str(tmp_path / "mine.bin"), str(tmp_path / "ref.bin")
    pack_token_file(toks, mine)
    jdata.pack_token_file(toks, ref)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    got = list(itertools.islice(TokenDataset(ref).batches(3, 64, seed=7), 4))
    want = list(itertools.islice(
        jdata.TokenDataset(mine).batches(3, 64, seed=7), 4))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_byte_encoding_equals_the_reference(tmp_path):
    text = "hello tepdist — tpu native"
    toks = encode_bytes(text)
    np.testing.assert_array_equal(toks, jdata.encode_bytes(text))
    assert bytes(toks.astype(np.uint8)).decode("utf-8") == text
    path = str(tmp_path / "b.bin")
    pack_token_file(np.tile(toks, 50), path)
    assert TokenDataset(path).sample(np.random.default_rng(0), 1,
                                     16).shape == (1, 17)


def test_short_dataset_and_bad_files_raise(tmp_path):
    path = str(tmp_path / "s.bin")
    pack_token_file(np.arange(10), path)
    with pytest.raises(ValueError, match="seq"):
        TokenDataset(path).sample(np.random.default_rng(0), 1, 32)
    with pytest.raises(ValueError, match="1-D"):
        pack_token_file(np.zeros((2, 2)), path)
    (tmp_path / "x.bin").write_bytes(b"not a token file")
    with pytest.raises(ValueError, match="token file"):
        TokenDataset(str(tmp_path / "x.bin"))


def test_prefetch_matches_direct(tmp_path):
    toks = np.arange(4_000) % 512
    path = str(tmp_path / "p.bin")
    pack_token_file(toks, path)
    ds = TokenDataset(path)
    direct = list(itertools.islice(ds.batches(2, 32, seed=3), 4))
    pre = DevicePrefetcher(itertools.islice(ds.batches(2, 32, seed=3), 4),
                           device="cpu")
    got = list(pre)
    assert len(got) == 4
    for x, y in zip(direct, got):
        assert isinstance(y, torch.Tensor) and y.dtype == torch.int32
        np.testing.assert_array_equal(x, y.numpy())


def test_prefetch_places_trees():
    batch = (np.ones((2, 3), np.float32), {"labels": np.arange(2)})
    (x, d), = list(DevicePrefetcher(iter([batch]), device="cpu"))
    assert torch.equal(x, torch.ones(2, 3))
    assert torch.equal(d["labels"], torch.arange(2))


def test_prefetch_propagates_errors():
    def bad():
        yield np.zeros((2, 3), np.int32)
        raise RuntimeError("source broke")

    pre = DevicePrefetcher(bad(), device="cpu")
    next(pre)
    with pytest.raises(RuntimeError, match="source broke"):
        next(pre)


def test_fake_input_iterator_reuses_the_first_batch():
    calls = []

    def batch_fn(i):
        calls.append(i)
        return np.full(2, i)

    it = fake_input_iterator(batch_fn)
    assert [int(next(it)[0]) for _ in range(3)] == [0, 0, 0]
    assert calls == [0]
    it = fake_input_iterator(batch_fn, reuse_first=False)
    assert [int(next(it)[0]) for _ in range(3)] == [0, 1, 2]


def test_prefetcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePrefetcher(iter([]))


def test_training_on_real_tokens(tmp_path):
    """End to end on the port: byte-level token file -> sampler ->
    prefetcher -> GPT-2 train steps; loss decreases on repeated data."""
    import dataclasses

    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.train import plan_training

    text = "the quick brown fox jumps over the lazy dog. " * 200
    path = str(tmp_path / "corpus.bin")
    pack_token_file(encode_bytes(text), path)
    ds = TokenDataset(path)
    cfg = dataclasses.replace(gpt2.CONFIGS["test"], vocab_size=256)
    params = gpt2.init_params(cfg, seed=0, device="cpu")
    it = DevicePrefetcher(itertools.islice(ds.batches(8, 32, seed=0), 8),
                          device="cpu")
    first = next(it)
    plan = plan_training(lambda p, t: gpt2.loss_fn(p, t, cfg), adam(1e-3),
                         params, first, num_micro_batches=1, device="cpu")
    losses = [plan.step(first)] + [plan.step(b) for b in it]
    assert len(losses) == 8 and losses[-1] < losses[0]
