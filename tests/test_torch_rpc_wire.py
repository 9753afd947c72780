"""The port's wire (``tepdist_tpu_torch/rpc/{protocol,retry}.py`` and
``core/cluster_spec.py``) held to the JAX package's.

- the envelope and every literal byte for byte equal to
  ``tepdist_tpu.rpc.protocol``'s for the same values (fp32, int32, int64,
  bool and bf16, the reference's bf16 bytes from ``ml_dtypes``), and the
  reference's decoder reading the port's frames;
- the int8 chunk-scale wire: the same bytes, decoded within the
  reference's own error (``tests/test_comm_dtype.py``: max error < 1% of
  max |x|), integer payloads never cast;
- the retry policy's deadlines and classification on every verb;
- cluster specs round-tripping through JSON in both packages.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from tepdist_tpu.core import cluster_spec as jcs
from tepdist_tpu.rpc import protocol as jp
from tepdist_tpu.rpc import retry as jr
from tepdist_tpu_torch.core import cluster_spec as tcs
from tepdist_tpu_torch.rpc import protocol as tp
from tepdist_tpu_torch.rpc import retry as tr

torch.set_num_threads(2)


def _cases():
    rng = np.random.default_rng(0)
    return {
        "float32": rng.standard_normal((7, 5)).astype(np.float32),
        "int32": rng.integers(-9, 9, (3, 4)).astype(np.int32),
        "int64": rng.integers(0, 50257, (2, 9)).astype(np.int64),
        "bool": rng.random((4, 3)) > 0.5,
        "bfloat16": rng.standard_normal((6, 3)).astype(ml_dtypes.bfloat16),
        "scalar": np.float32(3.5),
    }


def _as_torch(arr):
    arr = np.asarray(arr)
    if arr.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


@pytest.mark.parametrize("name", list(_cases()))
def test_literal_bytes_equal_reference(name):
    arr = _cases()[name]
    jm, jb = jp.encode_literal(arr)
    tm, tb = tp.encode_literal(_as_torch(arr))
    assert tm == jm
    assert bytes(tb) == bytes(jb)
    back = tp.decode_literal(jm, jb)
    want = _as_torch(arr)
    assert back.dtype == want.dtype and back.shape == want.shape
    assert torch.equal(back, want)
    # The envelope around it, and the reference reading the port's frame.
    frame = tp.pack({"literal": tm, "step": 3}, [tb])
    assert frame == jp.pack({"literal": jm, "step": 3}, [jb])
    header, blobs = jp.unpack(frame)
    np.testing.assert_array_equal(
        np.asarray(jp.decode_literal(header["literal"], blobs[0]),
                   np.float64),
        np.asarray(arr, np.float64))


def test_envelope_frames_and_header_peek():
    """``pack_frames`` joins to ``pack``'s bytes; unpack of both forms
    and ``peek_header`` agree with the reference."""
    arr = _cases()["float32"]
    tm, tb = tp.encode_literal(torch.from_numpy(arr))
    frames = tp.pack_frames({"k": [1, 2]}, [tb, b"xyz"])
    assert frames.join() == jp.pack({"k": [1, 2]}, [bytes(tb), b"xyz"])
    for data in (frames, frames.join()):
        header, blobs = tp.unpack(data)
        assert header == {"k": [1, 2]}
        assert [bytes(b) for b in blobs] == [bytes(tb), b"xyz"]
    assert tp.peek_header(frames) == jp.peek_header(frames.join())
    with pytest.raises(ValueError, match="magic"):
        tp.unpack(b"nope" * 4)
    with pytest.raises(ValueError, match="truncated"):
        tp.unpack(frames.join()[:-2])


@pytest.mark.parametrize("wire", ["bfloat16", "float16"])
def test_downcast_wire_equals_reference(wire):
    x = np.random.default_rng(2).standard_normal((33, 9)).astype(np.float32)
    jm, jb = jp.encode_literal(x, wire_dtype=wire)
    tm, tb = tp.encode_literal(torch.from_numpy(x), wire_dtype=wire)
    assert tm == jm and bytes(tb) == bytes(jb)
    got = tp.decode_literal(tm, tb)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp.decode_literal(jm, jb)))


def test_int8_wire_equals_reference_within_its_error():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((129, 65)).astype(np.float32) * 0.1
    jm, jb = jp.encode_literal(x, wire_dtype="int8")
    tm, tb = tp.encode_literal(torch.from_numpy(x), wire_dtype="int8")
    assert tm == jm and bytes(tb) == bytes(jb)
    nf = memoryview(tp.encode_literal(torch.from_numpy(x))[1]).nbytes
    assert len(tb) < 0.3 * nf
    out = tp.decode_literal(tm, tb)
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jp.decode_literal(jm, jb)))
    rel = np.abs(out.numpy() - x).max() / np.abs(x).max()
    assert rel < 0.01
    ids = torch.arange(64, dtype=torch.int32)
    mi, bi = tp.encode_literal(ids, wire_dtype="int8")
    back = tp.decode_literal(mi, bi)
    assert back.dtype == torch.int32 and torch.equal(back, ids)


def _grpc_error(code_name):
    import grpc

    class E(grpc.RpcError):
        def code(self):
            return getattr(grpc.StatusCode, code_name)

        def details(self):
            return code_name
    return E(code_name)


def _errors(mod):
    return {
        "timeout": TimeoutError("t"),
        "connection": ConnectionError("c"),
        "oserror": OSError("o"),
        "server": mod.ServerError("s"),
        "stale": mod.StaleEpochError("STALE_EPOCH seen=1 current=2"),
        "runtime": RuntimeError("r"),
        "grpc_deadline": _grpc_error("DEADLINE_EXCEEDED"),
        "grpc_unavailable": _grpc_error("UNAVAILABLE"),
        "grpc_internal": _grpc_error("INTERNAL"),
    }


@pytest.mark.parametrize("verb", jp.METHODS)
def test_retry_deadlines_and_classification_equal_reference(verb):
    assert tp.METHODS == jp.METHODS
    assert tr.deadline_for(verb) == jr.deadline_for(verb)
    assert tr.deadline_for(verb, 1.5) == jr.deadline_for(verb, 1.5)
    jerr, terr = _errors(jr), _errors(tr)
    for kind in jerr:
        assert (tr.is_retryable(terr[kind], verb)
                == jr.is_retryable(jerr[kind], verb)), (verb, kind)


def test_retry_policy_and_stale_epoch_parse_equal_reference():
    import random

    assert tr.NO_DEADLINE_RETRY == jr.NO_DEADLINE_RETRY
    assert tr.DEADLINES == jr.DEADLINES
    assert (tr.DEFAULT_POLICY.backoff_schedule(rng=random.Random(3))
            == jr.DEFAULT_POLICY.backoff_schedule(rng=random.Random(3)))
    t = tr.parse_stale_epoch("x STALE_EPOCH seen=4 current=9 worker=1")
    j = jr.parse_stale_epoch("x STALE_EPOCH seen=4 current=9 worker=1")
    assert (t.seen, t.current) == (j.seen, j.current) == (4, 9)
    calls = []

    def flaky(method, payload, timeout):
        calls.append(method)
        if len(calls) < 3:
            raise ConnectionError("dropped")
        return b"ok"

    assert tr.call_with_retry(flaky, "Ping", b"", 1.0,
                              policy=tr.RetryPolicy(base_s=0.0)) == b"ok"
    assert len(calls) == 3


def test_cluster_spec_round_trips():
    data = {"workers": [
        {"ip": "10.0.0.1", "port": 2222, "gpu_ids": "0,1"},
        {"ip": "10.0.0.2", "port": 2223, "device_ids": [0, 1, 2],
         "task_index": 1}]}
    t, j = tcs.ClusterSpec.from_json(data), jcs.ClusterSpec.from_json(data)
    assert t.to_json() == j.to_json()
    assert tcs.ClusterSpec.from_json(t.to_json()) == t
    assert (t.total_devices, t.master.address) == (
        j.total_devices, j.master.address)
    assert [t.global_device_id(1, d) for d in (0, 1, 2)] == [
        j.global_device_id(1, d) for d in (0, 1, 2)]
    assert t.worker_of_device(3).task_index == 1
