"""Fault-tolerant checkpointing (``repro.checkpoint.manager``), with the
reference's format and contract.

Format: one ``shard_0.npz`` of flattened leaves keyed by path string, plus
``manifest.json`` (step, the sorted leaf paths, ``extra``, and a CRC32 per
leaf). A train state ``{"params", "opt", "compress", "step"}`` flattens to
``params/<named_parameters name>``, ``opt/m/<name>``, ``opt/v/<name>``,
``compress/error/<name>`` (int8 only) and ``step``. Writes go to
``<dir>/tmp.<step>``, then ``os.replace`` to ``<dir>/step_<step>``: atomic
on POSIX, so a job killed mid-save never corrupts the restore point.
``keep_last`` checkpoints are kept.

``save`` copies every leaf to the host before it returns (the train step
then overwrites the same tensors in place); with ``async_save`` the CRCs
and the disk write run on a thread, joined before the next save and by
``wait``. ``restore`` checks every leaf's CRC as it reads it (``np.savez``
stores leaves uncompressed, so a flipped byte on disk loads as silently
wrong weights), each leaf a memory map of its stored member
(:class:`StoredNpz`), and copies the leaves into the tensors of ``like``, the
model's own: the state stays the tensors the model trains. A corrupt or truncated newest
checkpoint falls back to the next older one, raising
``ft.faults.CorruptStream`` only when the whole chain is bad; an
explicitly requested step never falls back. Leaves that npz cannot store
natively (bf16) are stored as float32 and cast back on load.

Activation maps (``save_acts``) are stored as compressed streams: the
payload trimmed to its live blocks plus the packed 1-bit index, so the
file tracks Eq. 2/3's stored bits and not the dense map. On the card the
pack runs there (``compress.stream.compress``, the codec's pack kernel)
and ``restore_acts`` expands on the device it is given (the expander).
"""
from __future__ import annotations

import json
import logging
import math
import os
import shutil
import struct
import threading
import zipfile
import zlib
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

_log = logging.getLogger("repro_torch.checkpoint")

_SEP = "/"
_NATIVE = (np.float64, np.float32, np.float16, np.int64, np.int32, np.int16, np.int8,
           np.uint8, np.uint16, np.uint32, np.uint64, np.bool_)


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the array's bytes in C order (the reference's ``_crc``)."""
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B")) & 0xFFFFFFFF


def _leaves(tree: Any, path: tuple = ()):
    """(path, leaf) in the reference's pytree order: dict keys sorted,
    named-tuple fields and sequence items in order; None has no leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield _SEP.join(map(str, path)), tree


_NATIVE_TORCH = (torch.float64, torch.float32, torch.float16, torch.int64, torch.int32,
                 torch.int16, torch.int8, torch.uint8, torch.bool)


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (never a view of a live tensor); bf16 and
    other dtypes npz cannot store as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype not in _NATIVE_TORCH:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    arr = np.array(leaf)
    return arr if arr.dtype in _NATIVE else arr.astype(np.float32)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {k: _to_host(v) for k, v in _leaves(tree)}


def map_leaves(tree: Any, fn, path: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)`` (``key`` its
    path as :func:`_leaves` names it), dicts in their own order (a train
    state's order is the step's summation order); None stays None."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(getattr(tree, f), fn, path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(v, fn, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(_SEP.join(map(str, path)), tree)


def stored_value(leaf, arr):
    """A leaf that is not a tensor, replaced by its stored value ``arr``:
    a Python number where the leaf was one."""
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr.item())
    return np.asarray(arr).astype(np.asarray(leaf).dtype)


def _load_into(tree: Any, read):
    """``tree`` with every tensor leaf overwritten in place by ``read(key)``
    (cast to the leaf's dtype and device) and every other leaf replaced by
    the stored value (:func:`stored_value`)."""
    def load(key, leaf):
        arr = read(key)
        if isinstance(leaf, torch.Tensor):
            with torch.no_grad():
                leaf.copy_(torch.from_numpy(arr))
            return leaf
        return stored_value(leaf, arr)
    return map_leaves(tree, load)


def checked_reader(data, manifest: dict | None, label: str):
    """``read(key)``: leaf ``key`` of the open shard ``data`` (a mapping of
    leaf names to arrays: :func:`open_shard`), its CRC32
    checked against ``manifest``'s as it is read, once the shard's leaf
    set has been checked against the manifest's. A failure raises
    ``ft.faults.CorruptStream`` naming the leaf."""
    from ..ft.faults import CorruptStream
    paths, files = (manifest or {}).get("paths"), set(data)
    if paths is not None and set(paths) != files:
        raise CorruptStream(f"{label}: leaf set mismatch — manifest lists {len(paths)} "
                            f"leaves, shard holds {len(files)}")
    sums = (manifest or {}).get("checksums") or {}

    def read(key):
        try:
            arr = data[key]
        except Exception as e:  # a member cut short
            raise CorruptStream(f"{label}: leaf {key!r} unreadable "
                                f"({type(e).__name__}: {e})") from e
        if key in sums and _crc(arr) != int(sums[key]):
            raise CorruptStream(f"{label}: leaf {key!r} CRC mismatch (manifest "
                                f"{int(sums[key]):#010x}, on-disk {_crc(arr):#010x})")
        return arr
    return read


class StoredNpz(Mapping):
    """The leaves of an ``np.savez`` file (its members stored, not
    compressed), each opened as a copy-on-write memory map of the file
    when asked for: the whole array, read page by page as it is used.
    The members are mapped, not read through ``zipfile``, so the zip's own
    CRC of a member is never checked: the manifest's CRC32
    (:func:`checked_reader`) is the one hash of the bytes. A member the
    file does not hold whole raises."""

    def __init__(self, path: str):
        self.path, self.size, self.members = path, os.path.getsize(path), {}
        with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
            for info in zf.infolist():
                if info.compress_type != zipfile.ZIP_STORED or \
                        not info.filename.endswith(".npy"):
                    raise ValueError(f"{info.filename}: not a stored .npy member")
                f.seek(info.header_offset)
                head = f.read(30)
                if len(head) < 30 or head[:4] != b"PK\x03\x04":
                    raise ValueError(f"{info.filename}: no local header")
                names, extra = struct.unpack("<HH", head[26:30])
                f.seek(info.header_offset + 30 + names + extra)
                read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                               (2, 0): np.lib.format.read_array_header_2_0}[
                    np.lib.format.read_magic(f)]
                shape, fortran, dtype = read_header(f)
                self.members[info.filename[:-4]] = (f.tell(), shape, fortran, dtype)

    def __getitem__(self, key: str) -> np.ndarray:
        offset, shape, fortran, dtype = self.members[key]
        end = offset + math.prod(shape) * dtype.itemsize
        if end > self.size:
            raise ValueError(f"truncated: the leaf ends at byte {end} of {self.size}")
        if end == offset:
            return np.zeros(shape, dtype)
        return np.memmap(self.path, dtype=dtype, mode="c", offset=offset, shape=shape,
                         order="F" if fortran else "C")

    def __iter__(self):
        return iter(self.members)

    def __len__(self) -> int:
        return len(self.members)


def open_shard(path: str, host_id: int = 0, label: str = "ckpt") -> StoredNpz:
    """The leaves of ``<path>/shard_<host_id>.npz``; a file that does not
    open as one raises ``ft.faults.CorruptStream``."""
    from ..ft.faults import CorruptStream
    try:
        return StoredNpz(os.path.join(path, f"shard_{host_id}.npz"))
    except Exception as e:  # a truncated or foreign file
        raise CorruptStream(f"{label}: unreadable ({type(e).__name__}: {e})") from e


def read_manifest(path: str, label: str = "ckpt") -> dict:
    """``<path>/manifest.json``; one that does not read raises
    ``ft.faults.CorruptStream``."""
    from ..ft.faults import CorruptStream
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)
    except Exception as e:  # truncated json, missing file, ...
        raise CorruptStream(f"{label}: unreadable ({type(e).__name__}: {e})") from e


def load_pytree(path: str, like: Any, host_id: int = 0, manifest: dict | None = None,
                label: str = "ckpt") -> Any:
    """Load a shard into ``like``'s tensors, in place. With ``manifest``
    (its ``paths`` and ``checksums``) the shard's leaf set is checked first
    and each leaf's CRC32 as it is read, before it is copied: a failure
    raises ``ft.faults.CorruptStream`` naming the leaf, with the leaves
    before it already written (one read of the shard, not two)."""
    return _load_into(like, checked_reader(open_shard(path, host_id, label), manifest, label))


# ---------------------------------------------------------------------------
# Activation maps as compressed streams
# ---------------------------------------------------------------------------

def _stream_layout(shape: tuple[int, ...], bs: int, bc: int,
                   block_hw: int) -> tuple[tuple[int, int], int, int] | None:
    """The engine's tile-grid view of one map. 4-D NCHW maps use the paper's
    spatial ``b x b`` blocks (``core.engine.nchw_stream_dims``) first; other
    maps the token layout ``(..., K)`` with (bs, bc) tiles when it divides.
    None = store dense."""
    from ..core.engine import nchw_stream_dims

    nchw = nchw_stream_dims(shape, block_hw)
    if nchw is not None:
        m, k, b = nchw
        if b > 1 or block_hw == 1:
            return (m, k), b, b
    flat_k = shape[-1] if len(shape) >= 2 else 0
    flat_m = math.prod(shape[:-1]) if len(shape) >= 2 else 0
    if flat_m and flat_m % bs == 0 and flat_k % bc == 0:
        return (flat_m, flat_k), bs, bc
    return None


_STREAM_DTYPES = {torch.float32: "float32", torch.float16: "float16",
                  torch.bfloat16: "bfloat16"}


def save_compressed_acts(path: str, acts: dict[str, Any], bs: int = 8, bc: int = 128,
                         block_hw: int = 4) -> dict:
    """Persist activation maps as compressed streams in one .npz.

    Per map ``name``: ``<name>/payload`` (the live blocks only, bf16 as its
    uint16 bits), ``<name>/index`` (the packed bitmap), ``<name>/dtype``
    and ``<name>/meta`` = [*shape, m, k, bs, bc]. Token maps tile ``(...,
    K)`` with (bs, bc); 4-D NCHW maps use the paper's spatial ``block_hw``
    blocks. Each map is packed on its own device (the codec's pack kernel on
    the card); then the trimmed payload and the index come to the host.
    Maps that fit neither layout, or of another dtype, are stored dense
    under ``<name>/dense`` (bf16 as float32). Returns per-map
    ``{dense_bytes, stored_bytes}``."""
    from ..compress.stream import compress

    arrs: dict[str, np.ndarray] = {}
    stats: dict[str, dict] = {}
    for name, x in acts.items():
        x = torch.as_tensor(x)
        layout = _stream_layout(tuple(x.shape), bs, bc, block_hw)
        dense_bytes = x.numel() * x.element_size()
        if layout is None or x.dtype not in _STREAM_DTYPES:
            arrs[f"{name}/dense"] = _to_host(x)
            stats[name] = {"dense_bytes": dense_bytes, "stored_bytes": dense_bytes}
            continue
        (m_dim, k_dim), ebs, ebc = layout
        cm = compress(x.reshape(m_dim, k_dim), bs=ebs, bc=ebc)
        payload = cm.payload[:int(cm.n_live)]                  # the actual trim
        if payload.dtype == torch.bfloat16:                    # not npz-native
            payload = payload.view(torch.uint16)
        payload, index = payload.cpu().numpy(), cm.index.cpu().numpy()
        arrs[f"{name}/dtype"] = np.asarray(_STREAM_DTYPES[x.dtype])
        arrs[f"{name}/payload"] = payload
        arrs[f"{name}/index"] = index
        arrs[f"{name}/meta"] = np.asarray([*x.shape, cm.m, cm.k, ebs, ebc], np.int64)
        stats[name] = {"dense_bytes": dense_bytes,
                       "stored_bytes": payload.nbytes + index.nbytes}
    np.savez(path, **arrs)
    return stats


def load_compressed_acts(path: str, validation: str = "off",
                         device=None) -> dict[str, torch.Tensor]:
    """Inverse of :func:`save_compressed_acts`: the dense maps, bit exact, on
    ``device`` (default the CPU).

    ``validation`` (a ``compress.integrity`` level) checks each stream's
    wire contract before expansion: a flipped on-disk index bit would
    otherwise silently move every later payload block. Raises
    ``ft.faults.CorruptStream`` naming the map and the invariant."""
    from ..compress.integrity import validate_map
    from ..compress.stream import CompressedMap, decompress

    device = torch.device(device or "cpu")
    out: dict[str, torch.Tensor] = {}
    with np.load(path) as data:
        for key in data.files:
            if "/" not in key:                 # save_acts(compressed=False) keys
                out[key] = torch.from_numpy(data[key]).to(device)
                continue
            name, kind = key.rsplit("/", 1)
            if kind == "dense":
                out[name] = torch.from_numpy(data[key]).to(device)
            elif kind == "payload":
                meta = data[f"{name}/meta"]
                m, k, bs, bc = (int(v) for v in meta[-4:])
                shape = tuple(int(v) for v in meta[:-4])
                payload = torch.from_numpy(data[key])
                if str(data[f"{name}/dtype"]) == "bfloat16":
                    payload = payload.view(torch.bfloat16)
                full = torch.zeros(((m // bs) * (k // bc), bs, bc), dtype=payload.dtype,
                                   device=device)
                full[:payload.shape[0]] = payload.to(device)
                cm = CompressedMap(payload=full,
                                   index=torch.from_numpy(data[f"{name}/index"]).to(device),
                                   n_live=torch.tensor(payload.shape[0], dtype=torch.int32,
                                                       device=device),
                                   shape=shape, m=m, k=k, bs=bs, bc=bc)
                if validation != "off":
                    validate_map(cm, level=validation, site=f"ckpt-acts:{name}")
                out[name] = decompress(cm)
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _write(self, tmp: str, final: str, flat: dict[str, np.ndarray],
               manifest: dict) -> None:
        os.makedirs(tmp, exist_ok=True)
        # the leaf CRCs ride the writer thread, beside the disk write (zlib
        # lets go of the interpreter lock): hashing GBs of weights must not
        # block the train loop any more than the write does
        with ThreadPoolExecutor(max_workers=4) as pool:
            sums = pool.map(_crc, flat.values())
            np.savez(os.path.join(tmp, "shard_0.npz"), **flat)
            manifest = dict(manifest, checksums=dict(zip(flat, sums)))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._gc()

    def _write_async(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:      # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _gc(self) -> None:
        steps = self._steps_on_disk()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """Checkpoint ``tree`` as step ``step``. Every leaf is on the host
        when this returns; the write (and, async, the CRCs) may still run."""
        self.wait()
        self._publish(step, _flatten(tree), extra)

    def _publish(self, step: int, flat: dict[str, np.ndarray], extra: dict | None) -> None:
        """Write the host leaves ``flat`` as step ``step``: on the writer
        thread with ``async_save``."""
        manifest = {"step": int(step), "paths": sorted(flat), "extra": extra or {}}
        tmp = os.path.join(self.dir, f"tmp.{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if self.async_save:
            self._thread = threading.Thread(target=self._write_async,
                                            args=(tmp, final, flat, manifest), daemon=True,
                                            name=f"ckpt-writer-{step}")
            self._thread.start()
        else:
            self._write(tmp, final, flat, manifest)

    def wait(self) -> None:
        """Join the writer thread; re-raise what the write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def all_steps(self) -> list[int]:
        return self._steps_on_disk()

    def _steps_on_disk(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save_acts(self, step: int, acts: dict[str, Any], compressed: bool = True,
                  bs: int = 8, bc: int = 128, block_hw: int = 4) -> dict:
        """Zebra-masked activation maps of ``step`` in compressed stream form
        (:func:`save_compressed_acts`), or dense with ``compressed=False``."""
        path = os.path.join(self.dir, f"acts_{step}.npz")
        if not compressed:
            arrs = {name: _to_host(x) for name, x in acts.items()}
            np.savez(path, **arrs)
            return {name: {"dense_bytes": a.nbytes, "stored_bytes": a.nbytes}
                    for name, a in arrs.items()}
        return save_compressed_acts(path, acts, bs=bs, bc=bc, block_hw=block_hw)

    def restore_acts(self, step: int, validation: str = "structural",
                     device=None) -> dict[str, torch.Tensor]:
        return load_compressed_acts(os.path.join(self.dir, f"acts_{step}.npz"),
                                    validation=validation, device=device)

    # ------------------------------------------------------------------
    def verify(self, step: int) -> dict:
        """Check one checkpoint end to end (a readable manifest, the same leaf
        set, every leaf's CRC) through the restore's reader and return its
        manifest. Raises ``ft.faults.CorruptStream`` naming what failed.
        Manifests without checksums verify structurally only."""
        path, label = os.path.join(self.dir, f"step_{step}"), f"ckpt step_{step}"
        manifest = read_manifest(path, label)
        data = open_shard(path, label=label)
        read = checked_reader(data, manifest, label)
        for key in sorted(data):
            read(key)
        return manifest

    def _load(self, path: str, like: Any, manifest: dict | None, label: str) -> Any:
        return load_pytree(path, like, manifest=manifest, label=label)

    def restore(self, like: Any, step: int | None = None,
                verify: bool = True) -> tuple[int, Any, dict]:
        """Restore the newest verified checkpoint (or the explicit ``step``)
        into ``like``'s tensors, checking each leaf's CRC as it is read. A
        corrupt candidate falls back to the next older step with a warning
        (which overwrites every leaf again); an explicitly requested step
        never falls back. Returns ``(step, tree, extra)``."""
        from ..ft.faults import CorruptStream
        self.wait()
        candidates = [step] if step is not None else list(reversed(self.all_steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        last: Exception | None = None
        try:
            for s in candidates:
                path = os.path.join(self.dir, f"step_{s}")
                try:
                    manifest = read_manifest(path, f"ckpt step_{s}")
                    tree = self._load(path, like, manifest if verify else None,
                                      f"ckpt step_{s}")
                    return s, tree, manifest.get("extra", {})
                except Exception as e:  # noqa: BLE001 - chain fallback below
                    if step is not None:
                        raise
                    # the text, not the exception: a handler that keeps its
                    # records would keep the traceback, and so ``like``
                    _log.warning("ckpt step_%s failed to restore (%s); falling back to "
                                 "older step", s, str(e))
                    last = e
            raise CorruptStream(f"no restorable checkpoint under {self.dir}: all of "
                                f"{candidates} failed verification") from last
        finally:
            last = None        # its traceback holds this frame: no cycle
