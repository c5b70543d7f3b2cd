"""Atomic, versioned, integrity-checked npz checkpoints of tensor trees:
the port of the JAX package's ``repro/checkpoint/store.py``, on the same
on-disk format, so each package reads the other's checkpoints.

Layout: ``<dir>/step_<n>/arrays.npz`` + ``meta.json``, written into a
``.tmp_ckpt_*`` directory and renamed, so a crash never leaves a
half-written checkpoint visible.  ``meta.json`` records ``format_version``
2 and the CRC32 of every array; ``restore`` checks them all and raises
:class:`CheckpointCorruptError` on a mismatch, a truncation or an
unreadable file.  ``latest_step(verify=True)`` walks newest-first and
returns the newest intact step.  ``gc`` keeps the newest ``keep_last``
steps and removes orphaned ``.tmp_ckpt_*`` directories.  The fault sites
``checkpoint.save_crash`` and ``checkpoint.corrupt`` fire where the
reference fires them.

Array keys.  An array's key is its path in the tree, the parts joined by
``/``, as the reference's ``_flatten_with_paths`` names them through
``jax.tree_util``: a dict entry contributes its key (dicts are walked in
sorted key order), a named tuple's field contributes ``.`` + the field's
name (JAX's ``GetAttrKey`` has no ``key`` or ``idx``, so its ``str``,
``.mu``, is used), and a list or tuple entry its index.  The training
state ``{"params", "opt": OptState(mu, nu, count), "step"}`` therefore
gives ``params/embed/tok``, ``opt/.mu/moe_buffer``, ``opt/.count`` and
``step``.  Each ``<key>.npy`` member is written as ``np.savez`` writes it
(stored, not compressed).

Memory and passes.  ``save`` takes each leaf to the host, writes its
bytes (its CRC32 computed beside the write) and drops it before the next;
``restore`` reads each array once from its offset in the file, checks its
CRC32 and puts it straight onto the target's device and dtype.  Neither
holds more than one leaf on the host, and ``restore`` never holds a
second copy of the state on the device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import faults
from repro_torch.common.faults import CheckpointCorruptError

__all__ = ["save", "restore", "verify", "verify_step", "latest_step",
           "list_steps", "meta", "gc",
           "CheckpointCorruptError", "CheckpointShapeError",
           "save_serving_state", "restore_serving_state",
           "latest_serving_step"]


class CheckpointShapeError(CheckpointCorruptError):
    """An intact checkpoint does not fit the restore target: an array's
    shape differs, or the target's array is missing (an older format).  A
    subclass of :class:`CheckpointCorruptError`, so a newest-first resume
    walk treats a layout-incompatible checkpoint like a damaged one; a
    caller that can re-lay the rows out (the elastic restore) catches it
    and retries with a ``remap``."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, prefix: str = ""):
    """(key, leaf) pairs in the reference's flattening order."""
    def join(part):
        return part if not prefix else f"{prefix}/{part}"
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], join(str(k)))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), join("." + f))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, join(str(i)))
    else:
        yield prefix, tree


def _unflatten_like(tree, values: Dict[str, Any], prefix: str = ""):
    def join(part):
        return part if not prefix else f"{prefix}/{part}"
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], values, join(str(k)))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[_unflatten_like(getattr(tree, f), values,
                                            join("." + f))
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, values, join(str(i)))
                          for i, v in enumerate(tree))
    return values[prefix]


def to_numpy(leaf) -> np.ndarray:
    """A leaf on the host as numpy (a tensor is copied off its device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.view(np.uint8) if a.dtype == object else a.data)


def _write_npz(path: str, items: Iterable[Tuple[str, np.ndarray]]
               ) -> Dict[str, int]:
    """Write ``(key, array)`` pairs one at a time as ``np.savez`` writes
    them (a stored ``<key>.npy`` member each, readable by ``np.load``);
    returns each array's CRC32.  The array's bytes go to the member as
    they are, with no copy, and their CRC32 runs on a second thread
    beside the write (``zlib`` lets go of the GIL)."""
    sums = {}
    with ThreadPoolExecutor(1) as pool, \
            zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                            allowZip64=True) as zf:
        for key, arr in items:
            arr = np.asanyarray(arr)
            if not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr)
            crc = pool.submit(_crc, arr)
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                if arr.size:
                    f.write(memoryview(arr.reshape(-1)).cast("B"))
            sums[key] = crc.result()
    return sums


def save(directory: str, step: int, tree: Any,
         extra_meta: Optional[dict] = None, *,
         arrays: Optional[Iterable[Tuple[str, Any]]] = None) -> str:
    """Save ``tree`` as checkpoint ``step`` (see the module's docstring).
    ``arrays``: the ``(key, leaf)`` pairs to write in place of
    ``tree``'s own (a process grid hands over its assembled global
    arrays this way, one at a time)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        pairs = arrays if arrays is not None else _walk(tree)
        sums = _write_npz(os.path.join(tmp, "arrays.npz"),
                          ((k, to_numpy(v)) for k, v in pairs))
        m = {"step": step, "num_arrays": len(sums), "format_version": 2,
             "checksums": sums, **(extra_meta or {})}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(m, f)
        # fault site: a crash between writing the arrays and the rename
        # must never surface a partial step_* directory
        faults.fire("checkpoint.save_crash")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # fault site: corruption after the rename (a torn write, bit rot),
    # caught by the checksums on restore
    faults.fire("checkpoint.corrupt", os.path.join(final, "arrays.npz"))
    return final


def _step_dirs(directory: str):
    """Decodable (step, dirname) pairs, sorted; stray non-numeric
    ``step_*`` entries (a user's ``step_final/``) are skipped."""
    out = []
    for d in os.listdir(directory):
        if not d.startswith("step_"):
            continue
        try:
            out.append((int(d.split("_", 1)[1]), d))
        except ValueError:
            continue
    return sorted(out)


def list_steps(directory: str) -> list:
    """Every decodable checkpoint step in ``directory``, ascending (not
    verified: pair with ``verify_step``)."""
    if not os.path.isdir(directory):
        return []
    return [s for s, _ in _step_dirs(directory)]


def latest_step(directory: str, *, verify: bool = False) -> Optional[int]:
    """The newest checkpoint step (None when there is none); with
    ``verify`` the newest intact one."""
    if not os.path.isdir(directory):
        return None
    steps = [s for s, _ in _step_dirs(directory)]
    if not verify:
        return max(steps) if steps else None
    for s in sorted(steps, reverse=True):
        if verify_step(directory, s):
            return s
    return None


def _read_meta(path: str) -> dict:
    try:
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f)
    except Exception as e:
        raise CheckpointCorruptError(
            f"{path}/meta.json: unreadable ({e})") from e


class _Npz:
    """Reads the arrays of a checkpoint's ``arrays.npz`` straight from
    their offsets in the file: one read of each array's bytes, with none
    of the zip member's own CRC pass (the store checks its own CRC32 of
    every array).  A member that is not stored uncompressed is read
    through ``zipfile``."""

    def __init__(self, path: str):
        self.path = os.path.join(path, "arrays.npz")
        try:
            self._zf = zipfile.ZipFile(self.path)
            self._info = {i.filename[:-4]: i for i in self._zf.infolist()
                          if i.filename.endswith(".npy")}
            self._f = open(self.path, "rb")
        except Exception as e:          # missing / truncated / unreadable
            raise CheckpointCorruptError(
                f"{self.path}: unreadable ({e})") from e
        self.files = list(self._info)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()
        self._zf.close()

    def _header(self, f):
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        return read(f)

    def __getitem__(self, key: str) -> np.ndarray:
        info = self._info[key]
        try:
            if info.compress_type != zipfile.ZIP_STORED:
                with self._zf.open(info) as f:
                    return np.lib.format.read_array(f, allow_pickle=False)
            f = self._f
            f.seek(info.header_offset)
            local = f.read(30)
            if local[:4] != b"PK\x03\x04":
                raise ValueError("bad local header")
            n, m = (int.from_bytes(local[26:28], "little"),
                    int.from_bytes(local[28:30], "little"))
            f.seek(info.header_offset + 30 + n + m)
            shape, fortran, dtype = self._header(f)
            count = int(np.prod(shape, dtype=np.int64))
            arr = np.fromfile(f, dtype=dtype, count=count)
            if arr.size != count:
                raise ValueError(f"{arr.size} of {count} elements")
            return arr.reshape(shape, order="F" if fortran else "C")
        except Exception as e:
            raise CheckpointCorruptError(
                f"{self.path}: {key!r} unreadable ({e})") from e


def _check(path: str, key: str, arr: np.ndarray, sums) -> None:
    if sums is None:
        return
    got = _crc(arr)
    if got != sums[key]:
        raise CheckpointCorruptError(
            f"{path}/arrays.npz: checksum mismatch for {key!r} "
            f"({got:#010x} != {sums[key]:#010x})")


def _load_verified(path: str, keep: bool = True):
    """(every array of ``path`` on the host, or {} unless ``keep``, and
    the meta), each array checked against ``meta.json`` as it is read.
    Raises CheckpointCorruptError."""
    m = _read_meta(path)
    sums = m.get("checksums")
    arrays = {}
    with _Npz(path) as data:
        if sums is not None and set(sums) != set(data.files):
            raise CheckpointCorruptError(
                f"{path}/arrays.npz: array set mismatch vs meta.json")
        for k in data.files:
            arr = data[k]
            _check(path, k, arr, sums)
            if keep:
                arrays[k] = arr
    return arrays, m


def _verify_path(path: str) -> dict:
    return _load_verified(path, keep=False)[1]


def verify_step(directory: str, step: int) -> bool:
    """True iff checkpoint ``step`` exists and passes its integrity
    checks."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.isdir(path):
        return False
    try:
        _verify_path(path)
        return True
    except CheckpointCorruptError:
        return False


verify = verify_step


def restore(directory: str, step: int, target: Any, *,
            remap: Optional[Dict[str, Callable[[np.ndarray], np.ndarray]]]
            = None, device=None, checked: bool = False) -> Any:
    """Restore ``step`` into ``target``'s structure: each leaf a tensor
    (a ``meta`` tensor will do) or anything with ``shape`` and ``dtype``,
    whose device and dtype the restored tensor takes (``device``
    overrides a ``meta`` device).  Each array is read once, held to its
    CRC32 (``checked``: the caller verified the step already), passed
    through ``remap`` (keyed by the leaf's last path part, so
    ``"moe_buffer"`` matches ``params/moe_buffer`` and both moments'
    buffers), held to the target's shape, and put on the device, one at
    a time; the arrays the target does not take are checked after.  A
    failure drops what was restored.  Raises CheckpointCorruptError on a
    damaged checkpoint, and :class:`CheckpointShapeError` when an intact
    one does not fit the target (an array missing, or of another
    shape)."""
    path = os.path.join(directory, f"step_{step:08d}")
    m = _read_meta(path)
    sums = None if checked else m.get("checksums")
    leaves = list(_walk(target))
    values = {}
    with _Npz(path) as data:
        names = set(data.files)
        if sums is not None and set(sums) != names:
            raise CheckpointCorruptError(
                f"{path}/arrays.npz: array set mismatch vs meta.json")
        for key, _ in leaves:
            if key not in names:
                raise CheckpointShapeError(
                    f"{path}: missing array {key!r} for restore target")
        for key, leaf in leaves:
            arr = data[key]
            _check(path, key, arr, sums)
            fn = remap.get(key.rsplit("/", 1)[-1]) if remap else None
            if fn is not None:
                arr = fn(arr)
            if tuple(arr.shape) != tuple(leaf.shape):
                raise CheckpointShapeError(
                    f"{path}: array {key!r} has shape {arr.shape}, restore "
                    f"target wants {tuple(leaf.shape)}")
            values[key] = _to_device(arr, leaf, device)
            del arr
        if sums is not None:
            for key in names - set(values):
                _check(path, key, data[key], sums)
    return _unflatten_like(target, values)


def _to_device(arr: np.ndarray, leaf, device) -> torch.Tensor:
    dev = leaf.device if isinstance(leaf, torch.Tensor) else None
    if device is not None and (dev is None or dev.type == "meta"):
        dev = torch.device(device)
    dt = leaf.dtype if isinstance(leaf.dtype, torch.dtype) \
        else torch.from_numpy(np.zeros((), leaf.dtype)).dtype
    t = torch.from_numpy(np.require(arr, requirements="C"))
    return t.to(device=dev or "cpu", dtype=dt, copy=True)


def meta(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"step_{step:08d}", "meta.json")) as f:
        return json.load(f)


def gc(directory: str, keep_last: int = 3) -> list:
    """Delete all but the newest ``keep_last`` numeric ``step_*``
    checkpoints and every orphaned ``.tmp_ckpt_*`` directory (one writer
    per directory: any tmp dir here is dead).  Non-numeric ``step_*``
    entries and ``serving/`` stay.  Returns the removed paths."""
    if not os.path.isdir(directory):
        return []
    removed = []
    steps = _step_dirs(directory)
    drop = steps[:-keep_last] if keep_last > 0 else steps
    for _, d in drop:
        p = os.path.join(directory, d)
        shutil.rmtree(p, ignore_errors=True)
        removed.append(p)
    for d in os.listdir(directory):
        if d.startswith(".tmp_ckpt_"):
            p = os.path.join(directory, d)
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p)
    return removed


# ---------------------------------------------------------------------------
# Serving state: the plan tables, the published version and the scheduler's
# calibration and ShardingPlan, beside the parameters of the same step
# ---------------------------------------------------------------------------
_SERVE_SUBDIR = "serving"


def save_serving_state(directory: str, step: int, pa, version: int,
                       calibration: Optional[dict] = None,
                       sharding: Optional[dict] = None) -> str:
    """Save a serving state under ``<directory>/serving/step_<n>/``:
    ``pa`` a ``core.moe.PlanArrays`` (tensors or numpy), ``version`` the
    published parameter version (pair it with the parameter checkpoint of
    the same step), ``calibration`` numpy arrays such as the load
    predictor's history, ``sharding`` the live ShardingPlan's record
    (owner_dev, owner_row, num_devices, rows_per_device, k_local), which a
    resharding run needs to resume.  Atomic and checksummed like
    ``save``."""
    tree = {"plan": dict(pa._asdict()),
            "calibration": dict(calibration or {}),
            "sharding": dict(sharding or {})}
    return save(os.path.join(directory, _SERVE_SUBDIR), step, tree,
                extra_meta={"kind": "serving_state",
                            "serve_version": int(version)})


def latest_serving_step(directory: str, *, verify: bool = False
                        ) -> Optional[int]:
    return latest_step(os.path.join(directory, _SERVE_SUBDIR),
                       verify=verify)


def restore_serving_state(directory: str, step: Optional[int] = None
                          ) -> Optional[dict]:
    """The serving state of ``step`` (default: the newest intact one):
    ``{"pa": PlanArrays of numpy tables, "version", "calibration",
    "sharding", "step"}``, or None when there is none.  A requested
    corrupt step raises CheckpointCorruptError."""
    from repro_torch.core.moe import PlanArrays
    sub = os.path.join(directory, _SERVE_SUBDIR)
    if step is None:
        step = latest_step(sub, verify=True)
        if step is None:
            return None
    path = os.path.join(sub, f"step_{step:08d}")
    if not os.path.isdir(path):
        return None
    data, m = _load_verified(path)

    def group(name):
        return {k.split("/", 1)[1]: data[k] for k in data
                if k.startswith(name + "/")}
    return {"pa": PlanArrays(**group("plan")),
            "version": int(m["serve_version"]),
            "calibration": group("calibration"),
            "sharding": group("sharding"), "step": step}
