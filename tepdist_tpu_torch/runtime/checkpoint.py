"""Checkpoint save/restore: the port of ``tepdist_tpu/runtime/checkpoint.py``.

The on-disk format is the JAX package's, so each package reads the other's
checkpoints:

- ``step_{step:012d}/worker{i}.npz``, a zip of ``.npy`` entries written
  one variable at a time (``ZIP_STORED``) to a tmp name and renamed;
- bf16 stored as its uint16 bits under the key ``<name>::bfloat16``;
- shard entries ``<name>::shard{j}`` with a ``worker{i}.meta.json``
  sidecar giving each one's global index (written by the JAX package's
  multi-controller and ZeRO saves, and by the port's ZeRO pipeline, whose
  optimizer-state leaves are :class:`ShardPieces`; each package reads and
  assembles both);
- ``manifest.json``, the ``max_to_keep`` queue, guarded by an ``fcntl``
  lock and owned by worker 0.

Values to save are tensors (on any device) or numpy arrays. ``restore``
returns CPU tensors; bf16 is read from its bits straight into a
``torch.bfloat16`` view, so restoring never needs ``ml_dtypes``.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.tree import (tree_leaves, tree_structure,
                                         tree_unflatten)

Bounds = Tuple[Tuple[int, int], ...]


def _atomic_write(path: str, write_fn: Callable[[str], None]) -> None:
    """Write via a per-process tmp name + os.replace; never leaves a partial
    file at ``path`` and cleans the tmp on failure."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _npy(key: str, host) -> Tuple[str, np.ndarray]:
    """(npz key, numpy array) of one host value; npz has no bf16, so a
    bf16 value is stored as its uint16 bits under ``key::bfloat16``."""
    if isinstance(host, torch.Tensor):
        if host.dtype == torch.bfloat16:
            bits = host.view(torch.int16).numpy().view(np.uint16)
            return f"{key}::bfloat16", bits
        return key, host.numpy()
    if host.dtype.name == "bfloat16":
        return f"{key}::bfloat16", host.view(np.uint16)
    return key, host


# Shard extents (per-dim (start, stop) over the global shape), as the
# JAX package's parallel/redistribution.py plans them.

def _size(b: Bounds) -> int:
    n = 1
    for a, z in b:
        n *= max(z - a, 0)
    return n


def _overlap(a: Bounds, b: Bounds) -> Optional[Bounds]:
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def _plan_redistribution(src: List[Bounds], dst: List[Bounds]
                         ) -> List[List[Tuple[int, Bounds]]]:
    """Per destination extent, the source slices that fill it; raises
    when one is not fully covered (replicated sources count once)."""
    plan = []
    for d in dst:
        pieces, seen, covered = [], set(), 0
        for i, s in enumerate(src):
            inter = _overlap(s, d)
            if inter is None or inter in seen:
                continue
            seen.add(inter)
            pieces.append((i, inter))
            covered += _size(inter)
        if covered != _size(d):
            raise ValueError(
                f"redistribution coverage incomplete for dst {d}: "
                f"{covered}/{_size(d)} elements from {len(src)} source "
                "shards")
        plan.append(pieces)
    return plan


class AsyncSaveHandle:
    """Join handle for a background save (save_async)."""

    def __init__(self, step: int):
        self.step = step
        self.path: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.thread: Optional[threading.Thread] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> str:
        """Block until the write is durable; re-raise any writer error."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"save of step {self.step} still running")
        if self.error is not None:
            raise self.error
        assert self.path is not None
        return self.path


class ShardPieces:
    """A value held as pieces by several replicas or ranks: this writer's
    pieces as ``(piece id, bounds, tensor)``, the bounds one ``(start,
    stop)`` per dim of ``global_shape`` (ids unique across the writers of
    one value). Saved as shard entries; restored whole by assembly."""

    def __init__(self, global_shape, dtype, pieces):
        self.global_shape = tuple(global_shape)
        self.shape = self.global_shape
        self.dtype = dtype
        self.pieces = list(pieces)


class CheckpointUtil:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 own_manifest: bool = True, shard_addressable: bool = False):
        """``own_manifest=False`` makes this writer shard-only: it never
        touches the keep-queue or prunes (non-zero workers).

        ``shard_addressable=True`` writes a :class:`ShardPieces` value as
        per-shard entries (+ the index sidecar): the ZeRO save path, whose
        optimizer-state shards stay per-shard on disk, so
        ``restore_resharded`` can land them on any data-parallel width
        without the full array ever being built."""
        self.dir = directory
        self.max_to_keep = max_to_keep
        self.own_manifest = own_manifest
        self.shard_addressable = shard_addressable
        self._async_lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    @property
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    @contextlib.contextmanager
    def _manifest_lock(self):
        path = os.path.join(self.dir, ".manifest.lock")
        fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _load_manifest(self) -> Dict[str, Any]:
        try:
            with open(self._manifest_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {"steps": []}

    def _store_manifest(self, m: Dict[str, Any]) -> None:
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(m, f)
        _atomic_write(self._manifest_path, write)

    # ------------------------------------------------------------------
    @staticmethod
    def _fetch(value):
        """Device -> host copy of ONE variable (the streaming unit; tests
        hook this to assert bounded host residency). A copy even on the
        CPU: the training plan updates its tensors in place. A DTensor is
        gathered whole first (a collective: every rank saves together)."""
        if isinstance(value, torch.Tensor):
            if hasattr(value, "full_tensor"):
                value = value.full_tensor()
            return value.detach().to("cpu", copy=True)
        return np.array(value)

    def _stream_entries(self, variables: Dict[str, Any]
                        ) -> Iterable[Tuple[str, Any, Dict[str, Any]]]:
        """Yield (npz name, host copy, sidecar meta) ONE VARIABLE (or
        shard) AT A TIME: nothing keeps the previous one's host copy, so a
        save's peak host memory is its largest variable, not the state."""
        for k, v in variables.items():
            if not isinstance(v, ShardPieces):
                yield k, self._fetch(v), {}
                continue
            if not self.shard_addressable:
                raise ValueError(
                    f"'{k}' is held as shards: save it with "
                    "CheckpointUtil(shard_addressable=True)")
            for j, bounds, piece in v.pieces:
                key = f"{k}::shard{j}"
                yield key, self._fetch(piece), {
                    key: {"of": k, "index": [list(b) for b in bounds],
                          "global_shape": list(v.global_shape)}}

    def _write_streaming(self, step_dir: str, worker_id: int,
                         entries: Iterable[Tuple[str, Any, Dict]]) -> str:
        """Write an npz (zip-of-npy) INCREMENTALLY: each array goes to
        disk and is dropped before the next is fetched. np.load reads the
        result as a normal npz. Shard entries get the index sidecar,
        written before the npz is renamed into place."""
        final = os.path.join(step_dir, f"worker{worker_id}.npz")
        mpath = os.path.join(step_dir, f"worker{worker_id}.meta.json")
        shard_meta: Dict[str, Any] = {}
        # Thread-unique tmp: concurrent saves of the same (step, worker)
        # must not interleave one tmp file (the last os.replace wins).
        tmp = (f"{final}.tmp.{os.getpid()}.{threading.get_ident()}"
               f".{time.monotonic_ns()}")
        try:
            with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED,
                                 allowZip64=True) as zf:
                for name, host, meta in entries:
                    shard_meta.update(meta)
                    key, arr = _npy(name, host)
                    with zf.open(key + ".npy", "w", force_zip64=True) as f:
                        # NOT ascontiguousarray: it promotes 0-d to 1-d
                        # (adam counts would come back (1,)).
                        np.lib.format.write_array(
                            f, np.asarray(arr, order="C"),
                            allow_pickle=False)
                    del host, arr
            if shard_meta:
                # Meta first: an npz with ::shard keys but no sidecar
                # would be skipped by restore's assembly.
                def write_meta(t):
                    with open(t, "w") as f:
                        json.dump(shard_meta, f)
                _atomic_write(mpath, write_meta)
            os.replace(tmp, final)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
        return final

    @staticmethod
    def _clean_stale_tmps(step_dir: str) -> int:
        """Remove ``*.tmp.*`` files left in ``step_dir`` by writers that
        died mid-save. A tmp whose embedded writer pid is still alive,
        this process included (another thread's in-flight async save),
        is left alone. Called by the next save of the same step."""
        n = 0
        try:
            names = os.listdir(step_dir)
        except OSError:
            return 0
        for fn in names:
            if ".tmp." not in fn:
                continue
            pid_s = fn.split(".tmp.", 1)[1].split(".", 1)[0]
            try:
                pid = int(pid_s)
            except ValueError:
                continue
            if pid == os.getpid():
                continue
            try:
                os.kill(pid, 0)
                continue                  # writer alive: not stale
            except ProcessLookupError:
                pass                      # dead: stale
            except OSError:
                continue                  # EPERM etc: someone else's, skip
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(step_dir, fn))
                n += 1
        return n

    def _commit_step(self, step: int) -> None:
        if not self.own_manifest:
            return
        with self._manifest_lock():
            m = self._load_manifest()
            if step not in m["steps"]:
                m["steps"].append(step)
                m["steps"].sort()
            while len(m["steps"]) > self.max_to_keep:
                old = m["steps"].pop(0)
                shutil.rmtree(os.path.join(self.dir, f"step_{old:012d}"),
                              ignore_errors=True)
            m["last_saved"] = time.time()
            self._store_manifest(m)

    def _step_dir(self, step: int) -> str:
        step_dir = os.path.join(self.dir, f"step_{step:012d}")
        os.makedirs(step_dir, exist_ok=True)
        self._clean_stale_tmps(step_dir)
        return step_dir

    def save(self, step: int, variables: Dict[str, Any],
             worker_id: int = 0) -> str:
        """Write one step's variables; prune beyond max_to_keep. Variables
        are fetched and written ONE AT A TIME (bounded host memory)."""
        final = self._write_streaming(self._step_dir(step), worker_id,
                                      self._stream_entries(variables))
        self._commit_step(step)
        return final

    def save_async(self, step: int, variables: Dict[str, Any],
                   worker_id: int = 0) -> AsyncSaveHandle:
        """Background-thread save: the device->host snapshot happens NOW
        (the plan overwrites its tensors in place at the next step), the
        disk write runs on a daemon thread. Overlapping async saves
        serialize on a per-util lock; call ``.result()`` to join and
        surface errors."""
        snapshot = list(self._stream_entries(variables))
        step_dir = self._step_dir(step)
        handle = AsyncSaveHandle(step)

        def run():
            try:
                with self._async_lock:
                    handle.path = self._write_streaming(
                        step_dir, worker_id, iter(snapshot))
                    self._commit_step(step)
            except BaseException as e:  # noqa: BLE001 — surfaced in result()
                handle.error = e
            finally:
                handle._done.set()

        t = threading.Thread(target=run, name=f"ckpt-save-{step}",
                             daemon=True)
        handle.thread = t
        t.start()
        return handle

    # ------------------------------------------------------------------
    def _resolve_step(self, step: int) -> int:
        m = self._load_manifest()
        if not m["steps"]:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        if step < 0:
            step = m["steps"][-1]
        if step not in m["steps"]:
            raise FileNotFoundError(f"step {step} not in {m['steps']}")
        return step

    @staticmethod
    def _load_npz(path: str) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        with np.load(path) as loaded:
            for k in loaded.files:
                arr = loaded[k]
                if k.endswith("::bfloat16"):
                    out[k[:-10]] = torch.from_numpy(
                        arr.view(np.int16)).view(torch.bfloat16)
                else:
                    out[k] = torch.from_numpy(arr)
        return out

    def restore(self, step: int = -1, worker_id: int = 0
                ) -> Tuple[Dict[str, torch.Tensor], int]:
        """Read back this worker's variables as CPU tensors; shard entries
        are assembled to full tensors from every worker's files in the
        step directory."""
        step = self._resolve_step(step)
        step_dir = os.path.join(self.dir, f"step_{step:012d}")
        local = f"worker{worker_id}.npz"
        data = self._load_npz(os.path.join(step_dir, local))
        if not any("::shard" in k for k in data):
            return data, step
        out = {k: v for k, v in data.items() if "::shard" not in k}
        out.update(self._assemble_shards(step_dir, preloaded={local: data}))
        return out, step

    def restore_union(self, step: int = -1
                      ) -> Tuple[Dict[str, torch.Tensor], int]:
        """Merge EVERY worker's files for one step: whole entries from all
        files plus assembled shards (a surviving worker adopting a dead
        worker's state)."""
        step = self._resolve_step(step)
        step_dir = os.path.join(self.dir, f"step_{step:012d}")
        out: Dict[str, torch.Tensor] = {}
        preloaded: Dict[str, Dict[str, torch.Tensor]] = {}
        for fn in sorted(os.listdir(step_dir)):
            if not (fn.startswith("worker") and fn.endswith(".npz")):
                continue
            data = self._load_npz(os.path.join(step_dir, fn))
            preloaded[fn] = data
            for k, v in data.items():
                if "::shard" not in k:
                    out[k] = v
        out.update(self._assemble_shards(step_dir, preloaded=preloaded))
        return out, step

    def _assemble_shards(self, step_dir: str,
                         preloaded: Optional[Dict[str, Dict[str,
                                                             torch.Tensor]]]
                         = None) -> Dict[str, torch.Tensor]:
        """Merge every worker's shard files into full tensors. Coverage is
        checked by counting deduped shard extents against the global
        element count (shards are disjoint or identical)."""
        preloaded = preloaded or {}
        full: Dict[str, torch.Tensor] = {}
        covered: Dict[str, set] = {}
        for fn in sorted(os.listdir(step_dir)):
            if not (fn.startswith("worker") and fn.endswith(".npz")):
                continue
            mpath = os.path.join(step_dir, fn[:-4] + ".meta.json")
            if not os.path.exists(mpath):
                continue
            with open(mpath) as f:
                meta = json.load(f)
            data = (preloaded[fn] if fn in preloaded
                    else self._load_npz(os.path.join(step_dir, fn)))
            for key, m in meta.items():
                if key not in data:
                    continue
                name = m["of"]
                bounds = tuple((a, b) for a, b in m["index"])
                if name not in full:
                    full[name] = torch.zeros(m["global_shape"],
                                             dtype=data[key].dtype)
                    covered[name] = set()
                if bounds in covered[name]:
                    continue
                covered[name].add(bounds)
                full[name][tuple(slice(a, b) for a, b in bounds)] = data[key]
        for name, arr in full.items():
            n = sum(_size(bs) for bs in covered[name])
            if n != arr.numel():
                raise ValueError(
                    f"checkpoint shard coverage incomplete for '{name}' "
                    f"({n}/{arr.numel()} elements)")
        return full

    def shard_index(self, step: int = -1
                    ) -> Tuple[Dict[str, Dict[str, Any]], int]:
        """Map each sharded entry name -> ``{"global_shape", "pieces":
        [(npz_file, key, bounds), ...]}`` read from the per-worker meta
        sidecars only; no array data is loaded."""
        step = self._resolve_step(step)
        step_dir = os.path.join(self.dir, f"step_{step:012d}")
        idx: Dict[str, Dict[str, Any]] = {}
        for fn in sorted(os.listdir(step_dir)):
            if not (fn.startswith("worker") and fn.endswith(".meta.json")):
                continue
            with open(os.path.join(step_dir, fn)) as f:
                meta = json.load(f)
            npz = fn[:-len(".meta.json")] + ".npz"
            for key, m in meta.items():
                ent = idx.setdefault(
                    m["of"], {"global_shape": tuple(m["global_shape"]),
                              "pieces": []})
                ent["pieces"].append(
                    (npz, key, tuple((a, b) for a, b in m["index"])))
        return idx, step

    def restore_resharded(self, dst_bounds: Dict[str, List], step: int = -1
                          ) -> Tuple[Dict[str, List[torch.Tensor]], int]:
        """Assemble each DESTINATION extent directly from the overlapping
        saved slices (arXiv:2112.01075). ``dst_bounds`` maps entry name ->
        list of per-dim (start, stop) extents; returns one tensor per
        requested extent, in order. The full tensor is never built: peak
        host memory is one destination extent plus one source file."""
        idx, step = self.shard_index(step)
        step_dir = os.path.join(self.dir, f"step_{step:012d}")
        cache: Dict[str, Any] = {"fn": None, "data": None}

        def load(fn: str) -> Dict[str, torch.Tensor]:
            if cache["fn"] != fn:
                cache["data"] = self._load_npz(os.path.join(step_dir, fn))
                cache["fn"] = fn
            return cache["data"]

        out: Dict[str, List[torch.Tensor]] = {}
        for name, dsts in dst_bounds.items():
            if name not in idx:
                raise KeyError(
                    f"'{name}' has no sharded entry at step {step}")
            srcs = idx[name]["pieces"]
            plan = _plan_redistribution([b for _, _, b in srcs],
                                        [tuple(map(tuple, d)) for d in dsts])
            shards = []
            for d, pieces in zip(dsts, plan):
                # Group by source file so each npz decodes once per shard.
                pieces = sorted(pieces, key=lambda p: srcs[p[0]][0])
                probe = srcs[pieces[0][0]] if pieces else srcs[0]
                shard = torch.zeros([z - a for a, z in d],
                                    dtype=load(probe[0])[probe[1]].dtype)
                for i, inter in pieces:
                    fn, key, sb = srcs[i]
                    src = tuple(slice(lo - a, hi - a)
                                for (lo, hi), (a, _z) in zip(inter, sb))
                    dst = tuple(slice(lo - a, hi - a)
                                for (lo, hi), (a, _z) in zip(inter, d))
                    shard[dst] = load(fn)[key][src]
                shards.append(shard)
            out[name] = shards
        return out, step

    def steps(self) -> List[int]:
        return list(self._load_manifest()["steps"])


def save_sharded(directory: str, step: int, tree, max_to_keep: int = 5,
                 worker_id: int = 0):
    """Save a tree of tensors by flat leaf index (``"0"``, ``"1"``, ...);
    worker 0 owns the manifest and prune queue. Returns the tree's
    structure for :func:`restore_sharded`."""
    leaves = tree_leaves(tree)
    util = CheckpointUtil(directory, max_to_keep,
                          own_manifest=(worker_id == 0))
    util.save(step, {str(i): l for i, l in enumerate(leaves)},
              worker_id=worker_id)
    if worker_id == 0:
        with open(os.path.join(directory, "treedef.json"), "w") as f:
            json.dump({"n": len(leaves)}, f)
    return tree_structure(tree)


def restore_sharded(directory: str, treedef, step: int = -1,
                    worker_id: int = 0, device="cuda", mesh=None,
                    placements=None):
    """Restore a ``save_sharded`` tree onto ``device`` (shard entries
    assembled to full tensors).

    With a device ``mesh`` and target ``placements`` (one DTensor
    placement list per flat leaf), each leaf lands as a DTensor in the
    TARGET layout: a leaf saved as shards is redistributed straight into
    this rank's extent (``restore_resharded``, arXiv:2112.01075) — the
    destination mesh need not match the one that saved it, and the full
    tensor is never built on the host; a leaf saved whole is read and
    distributed. The JAX package's version takes target shardings."""
    util = CheckpointUtil(directory)
    if placements is None:
        dev = resolve_device(device)
        data, step = util.restore(step, worker_id)
        leaves = [data[str(i)].to(dev) for i in range(len(data))]
        return tree_unflatten(treedef, leaves), step

    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    idx, step = util.shard_index(step)
    whole = None
    leaves = []
    for i, spec in enumerate(placements):
        name, spec = str(i), list(spec)
        if name in idx:
            gshape = tuple(idx[name]["global_shape"])
            local, offset = compute_local_shape_and_global_offset(
                gshape, mesh, spec)
            dst = tuple((o, o + n) for o, n in zip(offset, local))
            shard = util.restore_resharded({name: [dst]}, step)[0][name][0]
            leaves.append(DTensor.from_local(
                shard.to(mesh.device_type), mesh, spec, run_check=False,
                shape=torch.Size(gshape),
                stride=torch.empty(gshape, device="meta").stride()))
        else:
            if whole is None:
                whole, _ = util.restore(step, worker_id)
            leaves.append(distribute_tensor(
                whole[name].to(mesh.device_type), mesh, spec))
    return tree_unflatten(treedef, leaves), step
