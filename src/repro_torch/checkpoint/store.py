"""Checkpointing of the train state: save/restore with a manifest, an
async writer, integrity hashes, and elastic resharding (restore onto
another ring layout than the one that wrote the checkpoint).

Counterpart of ``repro/checkpoint/store.py``, with its layout (one
directory a step):

    ckpt_dir/step_00000100/
        manifest.json      — step, flat keys, shapes, dtypes, crc32, extra
        arrays.npz         — {position: array}, whole arrays
    ckpt_dir/LATEST        — atomic pointer file

The keys are the port's flat state names: ``params::<state-dict name>``,
``opt::...`` (``opt::m::<name>`` for AdamW, ``opt::<JAX leaf>::vr`` for
Adafactor) and ``step``. As in JAX, arrays are whole on disk: a ring's
sharded tensors (``placement``, from
:func:`repro_torch.train.step.state_placement`) are gathered over the
group that splits them, world rank 0 (TP rank 0 of data rank 0) writes,
and the other ranks wait on a barrier. :func:`restore` slices each whole
array for this rank by the same placement, so a checkpoint written on a
4-rank ring restores on one device, a 2-rank ring or a 2 x 2 mesh, and the
reverse (JAX's ``sharding_fn``).

numpy has no bfloat16, so a bf16 tensor is stored as its raw 16 bits
(int16) with ``"bfloat16"`` in the manifest's dtypes; the crc is over those
bytes.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

SEP = "::"
BF16 = "bfloat16"

Placement = Mapping[str, Tuple[int, Any]]


def flatten(state: Mapping) -> Dict[str, Any]:
    """The train state ``{"params", "opt", "step"}`` (nested dicts of
    tensors) -> {flat key: leaf}, keys joined by ``::``."""
    flat: Dict[str, Any] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}{SEP}{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = v
    walk(state, "")
    return flat


def _world(group):
    """The ranks that take part: a mesh's world, a TP ring, or None."""
    return getattr(group, "world", group)


def _barrier(group) -> None:
    world = _world(group)
    if world is not None and world.size > 1:
        world.all_reduce(torch.zeros(1))


def _writes(group) -> bool:
    world = _world(group)
    return world is None or world.rank == 0


def _to_host(t, gathered: bool) -> np.ndarray:
    """A host copy of ``t`` that no later in-place update can change (on
    the CPU, ``.cpu()`` is the tensor itself); bf16 as its int16 bits."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t, dtype=np.int32 if isinstance(t, int) else None)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    host = t.cpu()
    if host is t and not gathered:
        host = host.clone()
    return host.numpy()


def _gather(flat: Mapping, placement: Optional[Placement], keep: bool
            ) -> Tuple[Dict[str, np.ndarray], list]:
    """Whole host arrays of every leaf (the sharded ones gathered over
    their groups, every rank taking part) and their dtypes' names; a rank
    that does not write (``keep`` False) joins the gathers and keeps
    nothing."""
    host, dtypes = {}, []
    for key, t in flat.items():
        place = (placement or {}).get(key)
        gathered = place is not None and place[1].size > 1
        if gathered:
            t = place[1].all_gather(t.detach(), place[0])
        if not keep:
            continue
        dtypes.append(BF16 if isinstance(t, torch.Tensor)
                      and t.dtype == torch.bfloat16 else None)
        host[key] = _to_host(t, gathered)
        if dtypes[-1] is None:
            dtypes[-1] = str(host[key].dtype)
    return host, dtypes


def _crc(a: np.ndarray) -> int:
    """crc32 of the array's bytes (``repro``'s ``crc32(a.tobytes())``,
    without the copy)."""
    return int(zlib.crc32(np.ascontiguousarray(a).data))


def _write(ckpt_dir: str, host: Mapping[str, np.ndarray], dtypes: list,
           step: int, extra: Optional[dict]) -> str:
    """Write a checkpoint of host arrays; returns its directory. Atomic via
    a temporary directory and ``os.replace``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_{name}_")
    arrays = list(host.values())
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{str(i): a for i, a in enumerate(arrays)})
    manifest = {
        "step": int(step),
        "keys": list(host.keys()),
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": dtypes,
        "crc32": [_crc(a) for a in arrays],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    # a second save of the same step (a straggler's, then the periodic
    # one) replaces the first: move it aside, since os.replace cannot
    # replace a directory that holds files
    if os.path.exists(final):
        os.replace(final, tmp + ".old")
    os.replace(tmp, final)
    with open(os.path.join(ckpt_dir, ".LATEST_tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(ckpt_dir, ".LATEST_tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    shutil.rmtree(tmp + ".old", ignore_errors=True)
    return final


def save(ckpt_dir: str, state: Mapping, step: int,
         extra: Optional[dict] = None, *, group=None,
         placement: Optional[Placement] = None) -> str:
    """Write a checkpoint of the train state; returns its directory. Every
    rank of ``group`` (the model's mesh or TP ring; None on one device)
    calls it: the sharded tensors are gathered, world rank 0 writes, the
    others wait for it."""
    writes = _writes(group)
    host, dtypes = _gather(flatten(state), placement, writes)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    if writes:
        path = _write(ckpt_dir, host, dtypes, step, extra)
    _barrier(group)
    return path


class AsyncSaver:
    """Background-thread checkpoint writer: ``save`` gathers and copies the
    state to the host in the caller's thread (the collectives, and a
    snapshot that the next step's in-place update cannot change), and only
    the file writing runs in the background. Every rank calls ``save`` and
    ``wait`` at the same steps; ``wait()`` before process exit."""

    def __init__(self, ckpt_dir: str, group=None,
                 placement: Optional[Placement] = None):
        self.ckpt_dir, self.group, self.placement = ckpt_dir, group, placement
        self._thread: Optional[threading.Thread] = None
        self._pending = False
        self._error: Optional[BaseException] = None

    def save(self, state: Mapping, step: int,
             extra: Optional[dict] = None) -> None:
        self.wait()
        writes = _writes(self.group)
        host, dtypes = _gather(flatten(state), self.placement, writes)
        self._pending = True
        if not writes:
            return

        def work():
            try:
                _write(self.ckpt_dir, host, dtypes, step, extra)
            except Exception as e:      # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Until the last save is on disk, on every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier(self.group)
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    return int(name.split("_")[-1])


def read(ckpt_dir: str, step: Optional[int] = None, verify: bool = True
         ) -> Tuple[Dict[str, np.ndarray], dict]:
    """({flat key: whole array}, manifest) of a checkpoint (the latest
    unless ``step``), written by this module or by ``repro``'s; the crc32
    of every array verified. Arrays are numpy, but bf16 ones (the
    manifest's dtype ``"bfloat16"``) come back as bf16 tensors."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = [z[str(i)] for i in range(len(manifest["keys"]))]
    if verify:       # zlib releases the GIL: the arrays' sums in threads
        with ThreadPoolExecutor(max(1, min(8, len(arrays)))) as pool:
            crcs = list(pool.map(_crc, arrays))
        for key, got, crc in zip(manifest["keys"], crcs, manifest["crc32"]):
            if got != crc:
                raise IOError(f"checkpoint corruption detected in {key!r} "
                              "(crc mismatch)")
    arrays = [torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
              if dt == BF16 else a
              for a, dt in zip(arrays, manifest["dtypes"])]
    return dict(zip(manifest["keys"], arrays)), manifest


def load_state(state: Dict, whole: Mapping[str, Any],
               placement: Optional[Placement] = None) -> Dict:
    """Fill the train state ``state`` in place from ``whole`` ({flat key:
    the whole array}, numpy or torch): each tensor gets this rank's slice
    by ``placement``. Raises on a key ``whole`` lacks, or on an array that
    is not the tensor's whole shape."""
    flat = flatten(state)
    for key, t in flat.items():
        if key not in whole:
            raise KeyError(f"checkpoint missing {key!r}")
        a = whole[key]
        if key == "step":
            state["step"] = int(np.asarray(a))
            continue
        place = (placement or {}).get(key)
        shape = list(t.shape)
        if place is not None:
            shape[place[0]] *= place[1].size
        if list(a.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {list(a.shape)} is "
                             f"not the whole shape {shape}")
        src = torch.as_tensor(a)
        if place is not None and place[1].size > 1:
            dim, g = place
            size = t.shape[dim]
            src = src.narrow(dim, g.rank * size, size)
        with torch.no_grad():
            t.copy_(src)
    return state


def restore(ckpt_dir: str, state: Dict, *,
            placement: Optional[Placement] = None,
            step: Optional[int] = None, verify: bool = True
            ) -> Tuple[Dict, dict]:
    """Fill a freshly built train state in place from a checkpoint (the
    latest unless ``step``), each sharded tensor with this rank's slice by
    ``placement``, whatever layout wrote it; returns (state, manifest)."""
    whole, manifest = read(ckpt_dir, step, verify)
    return load_state(state, whole, placement), manifest
