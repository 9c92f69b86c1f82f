"""Tiered KV fabric — host-RAM spill tier + page serialization.

Counterpart of the JAX package's `serving/kvfabric.py`, in two parts:

- **A host-RAM page store** (`HostPageStore`): a shared-memory slab of
  fixed-size frames. Zero-ref retained pages *demote* here instead of
  being freed under pool pressure, and a later admission *promotes* them
  back into the device pool — the effective prefix cache is host-RAM
  sized, not device sized.
- **A bitwise, version-tagged wire format** (`pack_page`/`unpack_page`,
  `pack_transfer`/`unpack_transfer`): length-prefixed frames with a
  sha256 integrity trailer, the spill tier's at-rest format and the
  prefill -> decode transfer format of disaggregated serving. A truncated
  or corrupt frame raises `FrameError` — a clean, catchable rejection,
  never a scheduler-thread death.

The KVPG and KVXF frames are byte for byte the reference's, so either
package lands the other's pages. bf16 pages travel as their raw 2-byte
words under the dtype name ``"bfloat16"`` (a torch tensor viewed as
int16); `unpack_page` returns CPU torch tensors, which hold bf16 natively.

Page identity is the *prefix path*, not the block alone: keys are chained
digests ``d_i = sha256(d_{i-1} + block_bytes)`` seeded by `DIGEST_SEED`,
over the exact token bytes the radix trie indexes
(`KVCacheState._blocks`), so a spill hit can never alias across prefixes.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import weakref
from collections import OrderedDict
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.util.locks import DiagnosedLock

#: chained-digest seed — part of the wire format; bump with VERSION
DIGEST_SEED = b"tpu-dl4j/kvfabric/v1"
#: per-page frame magic + format version
PAGE_MAGIC = b"KVPG"
#: multi-page transfer envelope magic + format version
TRANSFER_MAGIC = b"KVXF"
VERSION = 1

_PAGE_HDR = struct.Struct("<4sHI")      # magic, version, json header len
_U64 = struct.Struct("<Q")
_SHA_LEN = 32

#: wire dtype name -> (torch dtype, the numpy dtype its bytes are read as)
_WIRE_DTYPES = {
    "float32": (torch.float32, np.float32),
    "float16": (torch.float16, np.float16),
    "float64": (torch.float64, np.float64),
    "bfloat16": (torch.bfloat16, np.int16),     # raw 2-byte words
    "int8": (torch.int8, np.int8),
    "uint8": (torch.uint8, np.uint8),
    "int16": (torch.int16, np.int16),
    "int32": (torch.int32, np.int32),
    "int64": (torch.int64, np.int64),
}


class FrameError(ValueError):
    """A serialized KV frame failed validation (bad magic/version,
    truncation, length overrun, digest mismatch, or geometry that does
    not fit the receiving pool). Always catchable — the deserializer
    never lets malformed bytes crash the caller's thread."""


def _wire(a) -> Tuple[str, np.ndarray]:
    """A page array (torch tensor or numpy array) -> (wire dtype name,
    numpy array of its raw bytes, C-contiguous)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        name = str(t.dtype).replace("torch.", "")
        if name not in _WIRE_DTYPES:
            raise ValueError(f"no KV wire format for dtype {t.dtype}")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, t.numpy()
    a = np.ascontiguousarray(a)
    return str(a.dtype), a


def _dtype_of(name: str):
    try:
        return _WIRE_DTYPES[name]
    except KeyError:
        raise FrameError(f"frame names unknown dtype {name!r}") from None


def chain_digests(keys: Sequence[bytes],
                  seed: bytes = DIGEST_SEED) -> List[bytes]:
    """Chained path digests of a block-key sequence: ``d_i =
    sha256(d_{i-1} + key_i)`` with ``d_-1 = seed``. The i-th digest
    identifies block i *in the context of every block before it*."""
    digs, d = [], seed
    for key in keys:
        d = hashlib.sha256(d + key).digest()
        digs.append(d)
    return digs


def leading_digest(tokens, page_size: int) -> Optional[bytes]:
    """Digest of the first full page-aligned block of `tokens` (the
    prefix-affinity ownership unit), or None for sub-page prompts.
    Byte for byte the kvcache trie's block key convention."""
    t = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    if int(t.size) < page_size:
        return None
    return hashlib.sha256(
        DIGEST_SEED + t[:page_size].tobytes()).digest()


# ==========================================================================
# Per-page frame: header JSON + raw K bytes + raw V bytes + sha256 trailer
# ==========================================================================
def pack_page(k, v, digest: bytes) -> bytes:
    """Serialize one physical page's (K, V) — each shaped
    ``(n_layers, page_size, heads, head_dim)``, torch tensors or numpy
    arrays — into a self-describing, self-verifying frame. Bitwise: the
    receiver reconstructs the exact bytes, any dtype (f32 / bf16 /
    int8)."""
    kname, kb = _wire(k)
    vname, vb = _wire(v)
    hdr = json.dumps({
        "v": VERSION,
        "shape": [int(s) for s in kb.shape],
        "kdtype": kname,
        "vdtype": vname,
        "digest": digest.hex(),
    }, separators=(",", ":")).encode()
    kb, vb = kb.tobytes(), vb.tobytes()
    body = (_PAGE_HDR.pack(PAGE_MAGIC, VERSION, len(hdr)) + hdr
            + _U64.pack(len(kb)) + kb + _U64.pack(len(vb)) + vb)
    return body + hashlib.sha256(body).digest()


def unpack_page(buf: bytes, expect_digest: Optional[bytes] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Parse + verify one `pack_page` frame -> (k, v, header), k and v
    CPU tensors bitwise the packed ones. Raises FrameError on any
    malformation."""
    if len(buf) < _PAGE_HDR.size + _SHA_LEN:
        raise FrameError(f"page frame truncated ({len(buf)} bytes)")
    magic, ver, hlen = _PAGE_HDR.unpack_from(buf, 0)
    if magic != PAGE_MAGIC:
        raise FrameError(f"bad page-frame magic {magic!r}")
    if ver != VERSION:
        raise FrameError(f"page-frame version {ver} unsupported "
                         f"(this build speaks {VERSION})")
    body, trailer = buf[:-_SHA_LEN], buf[-_SHA_LEN:]
    if hashlib.sha256(body).digest() != trailer:
        raise FrameError("page-frame sha256 mismatch (corrupt transfer)")
    off = _PAGE_HDR.size
    if off + hlen > len(body):
        raise FrameError("page-frame header overruns the frame")
    try:
        hdr = json.loads(body[off:off + hlen])
    except ValueError as e:
        raise FrameError(f"page-frame header is not JSON: {e}") from e
    if not isinstance(hdr, dict):
        raise FrameError("page-frame header is not a JSON object")
    off += hlen
    arrays = []
    for dt_name in (hdr.get("kdtype"), hdr.get("vdtype")):
        if off + _U64.size > len(body):
            raise FrameError("page frame truncated inside a length prefix")
        (n,) = _U64.unpack_from(body, off)
        off += _U64.size
        if off + n > len(body):
            raise FrameError(
                f"page frame declares {n} payload bytes but only "
                f"{len(body) - off} remain")
        tdt, ndt = _dtype_of(str(dt_name))
        itemsize = np.dtype(ndt).itemsize
        try:
            shape = tuple(int(s) for s in hdr.get("shape", ()))
        except (TypeError, ValueError) as e:
            raise FrameError(f"page-frame shape is malformed: {e}") from e
        if int(np.prod(shape)) * itemsize != n:
            raise FrameError(
                f"payload length {n} does not match shape {shape} of "
                f"dtype {dt_name}")
        a = np.frombuffer(body, dtype=ndt, count=n // itemsize,
                          offset=off).reshape(shape)
        t = torch.from_numpy(a.copy())
        arrays.append(t.view(tdt) if tdt == torch.bfloat16 else t)
        off += n
    if off != len(body):
        raise FrameError(f"{len(body) - off} trailing bytes after the "
                         "page payload")
    if expect_digest is not None and hdr.get("digest") \
            != expect_digest.hex():
        raise FrameError("page frame carries digest "
                         f"{hdr.get('digest')!r}, expected "
                         f"{expect_digest.hex()!r} (prefix-path mismatch)")
    return arrays[0], arrays[1], hdr


# ==========================================================================
# Multi-page transfer envelope (the prefill -> decode shipment)
# ==========================================================================
def pack_transfer(tokens, frames: Sequence[bytes],
                  page_size: int) -> bytes:
    """Envelope a page-aligned token prefix + its per-page frames into
    one length-prefixed shipment (header+tokens integrity-sealed; each
    frame self-verifies via its own trailer)."""
    t = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    if int(t.size) % page_size or int(t.size) // page_size != len(frames):
        raise ValueError(
            f"transfer needs page-aligned tokens matching the frame "
            f"count (got {t.size} tokens / {len(frames)} frames of "
            f"page_size {page_size})")
    hdr = json.dumps({"v": VERSION, "page_size": int(page_size),
                      "n_tokens": int(t.size), "n_frames": len(frames)},
                     separators=(",", ":")).encode()
    tb = t.tobytes()
    head = (_PAGE_HDR.pack(TRANSFER_MAGIC, VERSION, len(hdr)) + hdr
            + _U64.pack(len(tb)) + tb)
    out = [head, hashlib.sha256(head).digest()]
    for fr in frames:
        out.append(_U64.pack(len(fr)))
        out.append(fr)
    return b"".join(out)


def check_frame(buf: bytes):
    """Cheap integrity gate on one sealed page frame: magic, version and
    the sha256 trailer — no array materialization. Raises FrameError."""
    if len(buf) < _PAGE_HDR.size + _SHA_LEN:
        raise FrameError(f"page frame truncated ({len(buf)} bytes)")
    magic, ver, _hlen = _PAGE_HDR.unpack_from(buf, 0)
    if magic != PAGE_MAGIC:
        raise FrameError(f"bad page-frame magic {magic!r}")
    if ver != VERSION:
        raise FrameError(f"page-frame version {ver} unsupported "
                         f"(this build speaks {VERSION})")
    if hashlib.sha256(buf[:-_SHA_LEN]).digest() != buf[-_SHA_LEN:]:
        raise FrameError("page-frame sha256 mismatch (corrupt transfer)")


def unpack_transfer(buf: bytes) -> Tuple[np.ndarray, List[bytes], dict]:
    """Parse a `pack_transfer` shipment -> (tokens, frames, header).
    FrameError on truncation/corruption anywhere in the envelope OR in
    any sealed frame (each frame's sha trailer is checked here, so a
    flipped byte is caught at the wire)."""
    if len(buf) < _PAGE_HDR.size:
        raise FrameError(f"transfer truncated ({len(buf)} bytes)")
    magic, ver, hlen = _PAGE_HDR.unpack_from(buf, 0)
    if magic != TRANSFER_MAGIC:
        raise FrameError(f"bad transfer magic {magic!r}")
    if ver != VERSION:
        raise FrameError(f"transfer version {ver} unsupported "
                         f"(this build speaks {VERSION})")
    off = _PAGE_HDR.size
    if off + hlen + _U64.size > len(buf):
        raise FrameError("transfer truncated inside its header")
    try:
        hdr = json.loads(buf[off:off + hlen])
    except ValueError as e:
        raise FrameError(f"transfer header is not JSON: {e}") from e
    if not isinstance(hdr, dict):
        raise FrameError("transfer header is not a JSON object")
    off += hlen
    (tlen,) = _U64.unpack_from(buf, off)
    off += _U64.size
    if off + tlen + _SHA_LEN > len(buf):
        raise FrameError("transfer truncated inside its token block")
    head_end = off + tlen
    if hashlib.sha256(buf[:head_end]).digest() \
            != buf[head_end:head_end + _SHA_LEN]:
        raise FrameError("transfer header sha256 mismatch")
    tokens = np.frombuffer(buf, np.int32, count=tlen // 4, offset=off)
    if int(tokens.size) != int(hdr.get("n_tokens", -1)):
        raise FrameError("transfer token count disagrees with header")
    off = head_end + _SHA_LEN
    frames: List[bytes] = []
    for _ in range(int(hdr.get("n_frames", 0))):
        if off + _U64.size > len(buf):
            raise FrameError("transfer truncated at a frame boundary")
        (n,) = _U64.unpack_from(buf, off)
        off += _U64.size
        if off + n > len(buf):
            raise FrameError(
                f"transfer frame declares {n} bytes but only "
                f"{len(buf) - off} remain (interrupted mid-shipment)")
        frame = buf[off:off + n]
        check_frame(frame)
        frames.append(frame)
        off += n
    if off != len(buf):
        raise FrameError(f"{len(buf) - off} trailing bytes after the "
                         "last frame")
    return np.asarray(tokens, np.int32), frames, hdr


def frame_capacity(n_layers: int, page_size: int, heads: int,
                   head_dim: int, dtype) -> int:
    """Upper bound on a packed page frame for this pool geometry (the
    host store's fixed slot size): exact modulo header digits, padded by
    a small slack so no legitimate frame is ever rejected. `dtype` is a
    torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        itemsize = torch.empty((), dtype=dtype).element_size()
    else:
        itemsize = np.dtype(dtype).itemsize
    per = n_layers * page_size * heads * head_dim * itemsize
    return _PAGE_HDR.size + 256 + 2 * (_U64.size + per) + _SHA_LEN


# ==========================================================================
# The host-RAM spill tier
# ==========================================================================
def _release_slab(shm: shared_memory.SharedMemory):
    """Module-level finalizer body (never a bound method: a method would
    keep the store alive and the finalizer would never fire)."""
    try:
        shm.close()
        shm.unlink()
    except Exception:   # noqa: BLE001 — best-effort teardown; the OS
        # reclaims the segment regardless and nobody is left to tell
        pass


def _create_slab(size: int) -> shared_memory.SharedMemory:
    """A shared-memory slab whose every byte is backed now. /dev/shm is a
    tmpfs that may be small (a container's default is 64 MiB), and a
    sparse segment would fault on its first write past the limit, killing
    the process; so the space is reserved up front and a shortfall is an
    error that names the bytes asked for."""
    try:
        shm = shared_memory.SharedMemory(create=True, size=size)
    except OSError as e:
        raise MemoryError(
            f"HostPageStore: cannot create a {size}-byte shared-memory "
            f"slab ({e}); shrink the spill tier or grow /dev/shm") from e
    try:
        fd = getattr(shm, "_fd", -1)
        if fd >= 0 and hasattr(os, "posix_fallocate"):
            os.posix_fallocate(fd, 0, size)
    except OSError as e:
        _release_slab(shm)
        raise MemoryError(
            f"HostPageStore: /dev/shm cannot back a {size}-byte slab "
            f"({e}); shrink the spill tier or grow /dev/shm") from e
    return shm


class HostPageStore:
    """Fixed-slot host-RAM page store over one SharedMemory slab.

    Demoted KV pages live here as packed frames keyed by their chained
    prefix-path digest; `get` promotes (MRU-touches) and `put` demotes,
    with LRU eviction once every slot is full — the same cache-not-
    working-memory contract as the device's retained set, one tier down.
    Thread-safe; writes are copies into the slab, so a frame handed back
    by `get` is immutable and durable the moment `put` returns (the
    spill-ordering guarantee kvcache eviction relies on).

    `stats` counts demotions, LRU evictions and rejected (oversize)
    frames."""

    def __init__(self, pages: int, frame_bytes: int, name: str = "lm",
                 time_fn: Callable[[], float] = None):
        if pages < 1 or frame_bytes < 1:
            raise ValueError(f"HostPageStore needs pages/frame_bytes "
                             f">= 1 (got {pages}/{frame_bytes})")
        self.pages = int(pages)
        #: slot layout: u64 payload length + the frame bytes
        self.slot_bytes = _U64.size + int(frame_bytes)
        self.frame_bytes = int(frame_bytes)
        self.name = name
        self._time = time_fn                # test seam (fake clocks)
        self._shm = _create_slab(max(1, self.pages * self.slot_bytes))
        self._lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.kvfabric.HostPageStore._lock")
        #: digest -> slot index; insertion order == LRU order
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self._free: List[int] = list(range(self.pages))
        self._bytes_used = 0
        self._last_put_at: Dict[bytes, float] = {}
        self._closed = False
        self.stats = {"demotions": 0, "evictions": 0, "rejects": 0}
        self._finalizer = weakref.finalize(self, _release_slab, self._shm)
        self._gauges()

    # ------------------------------------------------------------- metrics
    def _gauges(self):
        monitor.gauge(
            "serving_kv_spill_pages",
            "KV pages resident in the host-RAM spill tier",
            labels=("model",)).set(len(self._index), model=self.name)
        monitor.gauge(
            "serving_kv_spill_bytes",
            "Payload bytes resident in the host-RAM spill tier",
            labels=("model",)).set(self._bytes_used, model=self.name)

    # ------------------------------------------------------------- access
    def put(self, key: bytes, payload: bytes) -> bool:
        """Demote one packed frame under `key`. Durable (copied into the
        slab) before this returns True; False when the frame exceeds the
        slot size (counted, never an exception — a too-big frame just
        isn't spillable)."""
        if len(payload) > self.frame_bytes:
            with self._lock:
                self.stats["rejects"] += 1
            monitor.counter(
                "serving_kv_spill_rejects_total",
                "Demotions rejected by the spill tier (frame larger "
                "than the configured slot)",
                labels=("model",)).inc(model=self.name)
            return False
        with self._lock:
            if self._closed:
                return False
            slot = self._index.get(key)
            if slot is None:
                if not self._free:
                    old_key, slot = self._index.popitem(last=False)
                    (old_len,) = _U64.unpack_from(
                        self._shm.buf, slot * self.slot_bytes)
                    self._bytes_used -= old_len
                    self._last_put_at.pop(old_key, None)
                    self.stats["evictions"] += 1
                    monitor.counter(
                        "serving_kv_spill_evictions_total",
                        "Spill-tier frames evicted LRU to make room for "
                        "a newer demotion",
                        labels=("model",)).inc(model=self.name)
                else:
                    slot = self._free.pop()
            else:
                (old_len,) = _U64.unpack_from(
                    self._shm.buf, slot * self.slot_bytes)
                self._bytes_used -= old_len
            base = slot * self.slot_bytes
            _U64.pack_into(self._shm.buf, base, len(payload))
            self._shm.buf[base + _U64.size:
                          base + _U64.size + len(payload)] = payload
            self._index[key] = slot
            self._index.move_to_end(key)
            self._bytes_used += len(payload)
            if self._time is not None:
                self._last_put_at[key] = self._time()
            self.stats["demotions"] += 1
            monitor.counter(
                "serving_kv_spill_demotions_total",
                "KV pages demoted from the HBM pool into the host-RAM "
                "spill tier", labels=("model",)).inc(model=self.name)
            self._gauges()
            return True

    def get(self, key: bytes) -> Optional[bytes]:
        """Fetch a demoted frame (MRU touch); None when absent."""
        with self._lock:
            slot = self._index.get(key)
            if slot is None or self._closed:
                return None
            self._index.move_to_end(key)
            base = slot * self.slot_bytes
            (n,) = _U64.unpack_from(self._shm.buf, base)
            return bytes(self._shm.buf[base + _U64.size:
                                       base + _U64.size + n])

    def contains(self, key: bytes) -> bool:
        with self._lock:
            return key in self._index

    def drop(self, key: bytes):
        with self._lock:
            slot = self._index.pop(key, None)
            if slot is None:
                return
            (n,) = _U64.unpack_from(self._shm.buf,
                                    slot * self.slot_bytes)
            self._bytes_used -= n
            self._free.append(slot)
            self._last_put_at.pop(key, None)
            self._gauges()

    def keys(self, limit: int = 64) -> List[bytes]:
        """MRU-first resident keys (ownership advertisement input)."""
        with self._lock:
            out = list(reversed(self._index.keys()))
            return out[:max(0, int(limit))]

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    def describe(self) -> dict:
        with self._lock:
            return {"pages": self.pages,
                    "resident": len(self._index),
                    "frame_bytes": self.frame_bytes,
                    "bytes_used": self._bytes_used,
                    "stats": dict(self.stats)}

    def close(self):
        with self._lock:
            self._closed = True
            self._index.clear()
            self._free = list(range(self.pages))
            self._bytes_used = 0
        self._finalizer()
