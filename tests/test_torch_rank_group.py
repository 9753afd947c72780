"""The group form of the port's servicer (``rpc/rank_group.py``): which
device lists form one rank a device, a rank's failure reaching the caller
with its traceback within the stated time, no rank process outliving the
servicer, and a group-form pipeline's state read, saved and restored
through rank 0.

The servicers here run over ``["cpu"] * 2`` or ``["cpu"] * 4``: gloo ranks
started by the servicer, one torch thread each. This module imports no
JAX, so a rank can import its helpers (``call_each``).
"""

import os
import time

import numpy as np
import pytest
import torch

from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.rpc import inproc, rank_group, retry
from tepdist_tpu_torch.rpc.client import TepdistClient
from tepdist_tpu_torch.rpc.server import TepdistServicer

torch.set_num_threads(2)

_CUDA = [torch.device("cuda", i) for i in range(4)]


@pytest.mark.parametrize("devices, group", [
    (_CUDA, True),                                  # distinct cards: NCCL
    (_CUDA[:2], True),
    ([_CUDA[0]] * 4, False),                        # one card: one process
    ([_CUDA[0], _CUDA[1], _CUDA[1]], False),
    ([torch.device("cpu")] * 4, True),              # CPU devices: gloo
    ([torch.device("cpu")], False),
    ([_CUDA[1]], False),
    ([_CUDA[0], torch.device("cpu")], False),
], ids=["cards4", "cards2", "one_card_x4", "repeated_card", "cpu4", "cpu1",
        "card1", "mixed"])
def test_group_form_choice(devices, group):
    """Distinct cards and CPU devices form one rank a device; a repeated
    card (NCCL refuses two ranks on one card), one device or a mixed list
    stays one process (card-free: only the device list is read)."""
    assert rank_group.takes_group_form(devices) is group


def test_one_device_servicer_stays_in_process():
    assert TepdistServicer(["cpu"]).rank_group is None


def _address(name):
    return f"inproc:rank-group-{name}"


def test_rank_error_reaches_the_caller_and_ranks_end_with_it():
    """A malformed BuildExecutionPlan (its graph blob is not a graph)
    raises on every rank: the caller gets a rank's traceback at once and
    the group stays usable; unregistering the servicer ends every rank
    process."""
    servicer = TepdistServicer(["cpu"] * 2)
    address = _address("error")
    inproc.register_servicer(address, servicer)
    client = TepdistClient(address)
    try:
        assert client.ping()["n_devices"] == 2
        t0 = time.monotonic()
        with pytest.raises(retry.ServerError) as err:
            client.build_execution_plan(b"not a graph",
                                        mesh_axes=[["data", 2]])
        assert time.monotonic() - t0 < rank_group.RANK_ERROR_GRACE_S
        assert "Traceback" in str(err.value)
        assert "rank 0" in str(err.value) or "rank 1" in str(err.value)
        assert client.ping()["n_devices"] == 2
    finally:
        inproc.unregister_servicer(address)
        client.close()
    assert servicer.rank_group.alive() == [False, False]


def test_a_rank_that_cannot_start_stops_the_group():
    """Ranks that fail to start (here: cards on a host without CUDA)
    reach the caller's first verb with a rank's traceback, and every rank
    process is gone."""
    group = rank_group.RankGroup([torch.device("cuda", 0),
                                  torch.device("cuda", 1)], 0)
    with pytest.raises(RuntimeError, match="Traceback") as err:
        group.call_each(rank_group.rank_stats)
    assert "start" in str(err.value)
    assert group.alive() == [False, False]
    with pytest.raises(RuntimeError, match="stopped"):
        group.call_each(rank_group.rank_stats)


def stall_unless_rank1():
    """Rank 1 raises; rank 0 stays busy (as a peer waiting in a collective
    the failed rank never joins)."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails alone")
    time.sleep(120)


def test_a_rank_left_waiting_stops_the_group(monkeypatch):
    """One rank raises while another stays busy: the caller gets the
    traceback within the grace period, the ranks are killed, and the
    servicer refuses later verbs."""
    monkeypatch.setattr(rank_group, "RANK_ERROR_GRACE_S", 2.0)
    servicer = TepdistServicer(["cpu"] * 2)
    address = _address("stuck")
    inproc.register_servicer(address, servicer)
    client = TepdistClient(address)
    try:
        client.ping()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1 fails alone"):
            servicer.rank_group.call_each(stall_unless_rank1)
        assert time.monotonic() - t0 < 30
        assert servicer.rank_group.alive() == [False, False]
        with pytest.raises(retry.ServerError, match="stopped"):
            client.ping()
    finally:
        inproc.unregister_servicer(address)
        client.close()


def _deep_mlp(depth=8, width=512, batch=16):
    rng = np.random.default_rng(0)
    scale = (2.0 / width) ** 0.5
    params = {f"w{i}": torch.tensor(rng.standard_normal((width, width))
                                    * scale, dtype=torch.float32)
              for i in range(depth)}
    x = torch.tensor(rng.standard_normal((batch, width)),
                     dtype=torch.float32)
    y = torch.tensor(rng.standard_normal((batch, width)),
                     dtype=torch.float32)

    def loss(p, a, b):
        h = a
        for i in range(depth):
            h = torch.relu(h @ p[f"w{i}"])
        return ((h - b) ** 2).mean()
    return loss, params, x, y


def test_group_form_pipeline_state_goes_through_rank0(tmp_path,
                                                      monkeypatch):
    """A pipeline winner over 4 gloo ranks (the comm-bound regime): its
    state is fetched whole from the ranks, a save is written by rank 0
    alone, and a restore brings every rank back to it: the step after
    the restore repeats its loss and state bit for bit."""
    from tepdist_tpu_torch.client.session import TepdistSession
    from tepdist_tpu_torch.optim import adam, optimizer_spec

    monkeypatch.setenv("TEPDIST_CKPT_DIR", str(tmp_path))
    ServiceEnv.reset({"HBM_GB": "0.01", "ICI_BANDWIDTH": "0.05",
                      "COMM_OVERLAP": "0.0"})
    servicer = TepdistServicer(["cpu"] * 4)
    ServiceEnv.reset()
    address = _address("state")
    inproc.register_servicer(address, servicer)
    loss, params, x, y = _deep_mlp()
    try:
        sess = TepdistSession(address)
        summary = sess.compile_training(
            loss, adam(1e-3), params, x, y, num_micro_batches=4,
            optimizer_spec=optimizer_spec("adam", learning_rate=1e-3))
        assert summary["kind"] == "pipeline", summary
        assert "ranks, one a device" in summary["explored"]["pipeline_form"]
        first = sess.run(x, y)
        sess.save()
        saved_p, _ = sess.variables()
        after = sess.run(x, y)
        moved_p, _ = sess.variables()
        assert after < first
        sess.restore()
        assert all(torch.equal(a, b) for a, b in zip(
            sess.variables()[0].values(), saved_p.values()))
        assert sess.run(x, y) == after
        again_p, _ = sess.variables()
        for key in moved_p:
            assert torch.equal(again_p[key], moved_p[key]), key
        sess.close()
    finally:
        inproc.unregister_servicer(address)
    written = sorted(f for d in os.listdir(tmp_path)
                     if os.path.isdir(tmp_path / d)
                     for f in os.listdir(tmp_path / d))
    assert written == ["worker0.npz"], written
    assert not any(servicer.rank_group.alive())
