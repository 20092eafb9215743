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
wrong weights) and copies the leaves into the tensors of ``like``, the
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
import threading
import zlib
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


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf (never a view of a live tensor); bf16 and
    other dtypes npz cannot store as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype not in (torch.float64, torch.float32, torch.float16, torch.int64,
                           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool):
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()
    arr = np.array(leaf)
    return arr if arr.dtype in _NATIVE else arr.astype(np.float32)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {k: _to_host(v) for k, v in _leaves(tree)}


def _load_into(tree: Any, read, path: tuple = ()):
    """``tree`` with every tensor leaf overwritten in place by ``read(key)``
    (cast to the leaf's dtype and device) and every other leaf replaced by
    the stored value, as a Python number where the leaf was one."""
    if isinstance(tree, dict):
        return {k: _load_into(v, read, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_load_into(getattr(tree, f), read, path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_load_into(v, read, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    arr = read(_SEP.join(map(str, path)))
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            tree.copy_(torch.from_numpy(arr))
        return tree
    if isinstance(tree, (bool, int, float)):
        return type(tree)(arr.item())
    return arr.astype(np.asarray(tree).dtype)


def load_pytree(path: str, like: Any, host_id: int = 0, manifest: dict | None = None,
                label: str = "ckpt") -> Any:
    """Load a shard into ``like``'s tensors, in place. With ``manifest``
    (its ``paths`` and ``checksums``) the shard's leaf set is checked first
    and each leaf's CRC32 as it is read, before it is copied: a failure
    raises ``ft.faults.CorruptStream`` naming the leaf, with the leaves
    before it already written (one read of the shard, not two)."""
    from ..ft.faults import CorruptStream
    with np.load(os.path.join(path, f"shard_{host_id}.npz")) as data:
        paths = (manifest or {}).get("paths")
        if paths is not None and set(paths) != set(data.files):
            raise CorruptStream(f"{label}: leaf set mismatch — manifest lists {len(paths)} "
                                f"leaves, shard holds {len(data.files)}")
        sums = (manifest or {}).get("checksums") or {}

        def read(key):
            try:
                arr = data[key]
            except Exception as e:  # zip member CRC or truncation on read
                raise CorruptStream(f"{label}: leaf {key!r} unreadable "
                                    f"({type(e).__name__}: {e})") from e
            if key in sums and _crc(arr) != int(sums[key]):
                raise CorruptStream(f"{label}: leaf {key!r} CRC mismatch (manifest "
                                    f"{int(sums[key]):#010x}, on-disk {_crc(arr):#010x})")
            return arr
        return _load_into(like, read)


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
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """Checkpoint ``tree`` as step ``step``. Every leaf is on the host
        when this returns; the write (and, async, the CRCs) may still run."""
        self.wait()
        flat = _flatten(tree)
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
        set, every leaf's CRC) and return its manifest. Raises
        ``ft.faults.CorruptStream`` naming what failed. Manifests without
        checksums verify structurally only."""
        from ..ft.faults import CorruptStream      # ft's supervisor imports this module
        path = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            data = np.load(os.path.join(path, "shard_0.npz"))
            keys = set(data.files)
        except Exception as e:  # truncated zip or json, missing files, ...
            raise CorruptStream(
                f"ckpt step_{step}: unreadable ({type(e).__name__}: {e})") from e
        with data:
            paths = manifest.get("paths")
            if paths is not None and set(paths) != keys:
                raise CorruptStream(
                    f"ckpt step_{step}: leaf set mismatch — manifest lists "
                    f"{len(paths)} leaves, shard holds {len(keys)}")
            sums = manifest.get("checksums")
            if sums:
                for k in sorted(keys):
                    try:
                        got = _crc(data[k])
                    except Exception as e:  # zip member CRC or truncation on read
                        raise CorruptStream(f"ckpt step_{step}: leaf {k!r} unreadable "
                                            f"({type(e).__name__}: {e})") from e
                    want = int(sums.get(k, got))
                    if got != want:
                        raise CorruptStream(
                            f"ckpt step_{step}: leaf {k!r} CRC mismatch "
                            f"(manifest {want:#010x}, on-disk {got:#010x})")
        return manifest

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
                    try:
                        with open(os.path.join(path, "manifest.json")) as f:
                            manifest = json.load(f)
                    except Exception as e:  # truncated json, missing file, ...
                        raise CorruptStream(f"ckpt step_{s}: unreadable "
                                            f"({type(e).__name__}: {e})") from e
                    tree = load_pytree(path, like, manifest=manifest if verify else None,
                                       label=f"ckpt step_{s}")
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
