"""Multi-tenant LoRA adapter serving: paged, ref-counted adapter slots —
the port of `paddle_tpu/inference/serving/adapters.py`.

Thousands of fine-tuned variants over one base model, handled the way
the engine handles KV pages:

- :class:`LoraAdapter` — a named (rank, alpha) low-rank delta over the
  attention projections (``wq``/``wk``/``wv``/``wo``), numpy weights on
  the host; :func:`make_adapter` draws the reference's seeded weights
  bit for bit;
- :func:`save_adapter` / :func:`load_adapter` — a CRC'd, versioned JSON
  manifest with the model signature of `inference/quant/manifest.py`
  (atomic replace); the two packages read each other's files;
- :func:`pack_adapter` / :func:`unpack_adapter` — the fleet wire: a
  JSON header line, then the arrays, CRC over the body; raw f32 or the
  block-scaled q8 codec (`distributed/quant_comm.py`), whose bytes equal
  the reference's;
- :class:`AdapterTransport` — publish/fetch over any store with
  ``set``/``get`` of bytes (``torch.distributed.TCPStore``), or in
  process;
- :class:`AdapterManager` — a fixed number of device slots per rank
  class, pinned while requests are in flight, refcount-0 residents
  reclaimed in LRU order (a reload after eviction counts as a swap).

Every adapter of a rank class lives in one pair of stacked tensors a
target on the engine's device, ``A [L, S, din, c]`` / ``B [L, S, c,
dout]`` (S slots, c the rank padded to a power of 2). A slot is written
in place (``pack[:, slot].copy_``), never rebound: the engine's
captured decode tick holds the packs' addresses. Which adapter a row
uses is data (the engine's per-row selector); only the set of active
rank classes keys a new capture.

The reference's `FLAGS_adapter_slots` (4) and `FLAGS_adapter_wire_dtype`
('') are the constructor defaults here. Chaos site ``adapter`` (kinds
``evict``/``corrupt``/``delay``) is installed by
`distributed/fault_tolerance/chaos.py`.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...device import resolve
from ...distributed import quant_comm as QC
from ...models import llama as L
from ..quant.manifest import model_signature

__all__ = ["LoraAdapter", "AdapterManager", "AdapterTransport",
           "AdapterMissingError", "NoAdapterSlotsError",
           "AdapterCorruptError", "save_adapter", "load_adapter",
           "pack_adapter", "unpack_adapter", "make_adapter",
           "rank_class", "target_dims", "ADAPTER_TARGETS",
           "ADAPTER_MANIFEST_FORMAT", "DEFAULT_SLOTS"]

# the fixed target set every device pack covers (a missing target is
# zero-filled: its delta is exactly 0.0)
ADAPTER_TARGETS = ("wq", "wk", "wv", "wo")
ADAPTER_MANIFEST_FORMAT = "paddle-tpu-adapter-manifest"
ADAPTER_MANIFEST_VERSION = 1
DEFAULT_SLOTS = 4           # FLAGS_adapter_slots' default
DEFAULT_WIRE = ""           # FLAGS_adapter_wire_dtype's default

# chaos hook (site "adapter"): installed by
# distributed/fault_tolerance/chaos.py while a spec is active
_CHAOS_HOOK = [None]


def set_chaos_hook(fn):
    _CHAOS_HOOK[0] = fn


class AdapterMissingError(KeyError):
    """The named adapter is not registered with this AdapterManager."""


class NoAdapterSlotsError(RuntimeError):
    """Every device slot of the rank class is pinned by in-flight
    requests: nothing is LRU-evictable."""


class AdapterCorruptError(ValueError):
    """A wire blob failed its CRC or layout check."""


def rank_class(rank: int) -> int:
    """A LoRA rank padded up to its power of 2 (ranks 3 and 4 share a
    pack; the pad columns are zero, so the padded product is exact)."""
    r = max(1, int(rank))
    return 1 << (r - 1).bit_length()


def target_dims(cfg: L.LlamaConfig) -> Dict[str, Tuple[int, int]]:
    """(din, dout) of each adapter target projection for this model."""
    d = cfg.hidden_size
    qo = cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    return {"wq": (d, qo), "wk": (d, kv), "wv": (d, kv), "wo": (qo, d)}


@dataclass
class LoraAdapter:
    """One named LoRA delta: per target (A [L, din, r], B [L, r, dout])
    float32 host arrays; the applied delta is ``scaling * (h @ A) @ B``
    with ``scaling = alpha / rank``."""
    name: str
    rank: int
    alpha: float
    weights: Dict[str, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)
    version: int = 1

    @property
    def scaling(self) -> float:
        return float(self.alpha) / float(self.rank)

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes + b.nbytes
                       for a, b in self.weights.values()))

    def validate_for(self, cfg: L.LlamaConfig) -> None:
        dims = target_dims(cfg)
        for t, (a, b) in self.weights.items():
            if t not in dims:
                raise ValueError(f"adapter {self.name!r}: unknown target "
                                 f"{t!r} (serving covers {ADAPTER_TARGETS})")
            din, dout = dims[t]
            want_a = (cfg.num_layers, din, self.rank)
            want_b = (cfg.num_layers, self.rank, dout)
            if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
                raise ValueError(
                    f"adapter {self.name!r} target {t}: A{tuple(a.shape)} "
                    f"B{tuple(b.shape)} != expected A{want_a} B{want_b} "
                    f"for this model")


def make_adapter(cfg: L.LlamaConfig, name: str, rank: int = 4,
                 alpha: Optional[float] = None,
                 targets: Tuple[str, ...] = ADAPTER_TARGETS,
                 seed: int = 0, scale: float = 0.02) -> LoraAdapter:
    """A seeded random adapter (tests, smokes): A and B ~ N(0, scale),
    drawn as the reference draws them, so both give the same bits."""
    rng = np.random.default_rng(
        zlib.crc32(name.encode("utf-8")) + int(seed))
    dims = target_dims(cfg)
    weights = {}
    for t in targets:
        din, dout = dims[t]
        weights[t] = (
            rng.standard_normal((cfg.num_layers, din, rank)).astype(
                np.float32) * scale,
            rng.standard_normal((cfg.num_layers, rank, dout)).astype(
                np.float32) * scale)
    return LoraAdapter(name=name, rank=int(rank),
                       alpha=float(alpha if alpha is not None else rank),
                       weights=weights)


# ---------------------------------------------------------------------------
# Manifest persistence: canonical JSON, CRC32, atomic replace, signature.
# ---------------------------------------------------------------------------

def _canonical(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def save_adapter(adapter: LoraAdapter, cfg: L.LlamaConfig,
                 path: str) -> str:
    """Persist an adapter as a CRC'd versioned manifest. float32 values
    round-trip JSON exactly, so :func:`load_adapter` gives the same bits."""
    adapter.validate_for(cfg)
    payload = {
        "name": adapter.name,
        "rank": int(adapter.rank),
        "alpha": float(adapter.alpha),
        "adapter_version": int(adapter.version),
        "model": model_signature(cfg),
        "weights": {t: {"A": np.asarray(a, np.float32).tolist(),
                        "B": np.asarray(b, np.float32).tolist()}
                    for t, (a, b) in sorted(adapter.weights.items())},
    }
    doc = {"format": ADAPTER_MANIFEST_FORMAT,
           "version": ADAPTER_MANIFEST_VERSION,
           "crc32": zlib.crc32(_canonical(payload)) & 0xFFFFFFFF,
           "payload": payload}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".adapter_manifest_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_adapter(path: str,
                 cfg: Optional[L.LlamaConfig] = None) -> LoraAdapter:
    """Load and validate an adapter manifest. Raises ValueError on an
    unreadable file, a wrong format or version, a CRC mismatch, or (with
    ``cfg``) a model signature or shape that does not match."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable adapter manifest {path}: {e}") from e
    if doc.get("format") != ADAPTER_MANIFEST_FORMAT:
        raise ValueError(f"{path}: format {doc.get('format')!r} is not "
                         f"{ADAPTER_MANIFEST_FORMAT!r}")
    if doc.get("version") != ADAPTER_MANIFEST_VERSION:
        raise ValueError(f"{path}: manifest version {doc.get('version')} "
                         f"!= {ADAPTER_MANIFEST_VERSION}")
    payload = doc.get("payload") or {}
    if (zlib.crc32(_canonical(payload)) & 0xFFFFFFFF) != doc.get("crc32"):
        raise ValueError(f"{path}: adapter manifest CRC mismatch "
                         f"(truncated or hand-edited)")
    adapter = LoraAdapter(
        name=str(payload["name"]), rank=int(payload["rank"]),
        alpha=float(payload["alpha"]),
        version=int(payload.get("adapter_version", 1)),
        weights={t: (np.asarray(w["A"], np.float32),
                     np.asarray(w["B"], np.float32))
                 for t, w in payload.get("weights", {}).items()})
    if cfg is not None:
        if payload.get("model") != model_signature(cfg):
            raise ValueError(
                f"{path}: adapter was built for a different model "
                f"(signature {payload.get('model')} != "
                f"{model_signature(cfg)})")
        adapter.validate_for(cfg)
    return adapter


# ---------------------------------------------------------------------------
# Wire codec: one JSON header line + raw array bytes, CRC over the body,
# optionally the block-scaled q8 payload.
# ---------------------------------------------------------------------------

def _resolve_wire(wire: Optional[str]) -> str:
    if wire is None:
        wire = DEFAULT_WIRE
    if wire not in ("", "raw", "int8"):
        raise ValueError(f"adapter wire {wire!r} (want '' or 'int8')")
    return "int8" if wire == "int8" else "raw"


def pack_adapter(adapter: LoraAdapter, wire: Optional[str] = None) -> bytes:
    """Serialize an adapter for the fleet wire. ``wire='int8'`` encodes
    each array through the q8 codec (payload + f32 block scales)."""
    wire = _resolve_wire(wire)
    fields: List[dict] = []
    parts: List[bytes] = []
    for t, (a, b) in sorted(adapter.weights.items()):
        for side, arr in (("A", a), ("B", b)):
            flat = np.asarray(arr, np.float32).reshape(-1)
            if wire == "int8":
                block = QC.block_size()
                qpadded, nblocks, _ = QC.wire_layout(flat.size, block)
                padded = np.zeros((qpadded,), np.float32)
                padded[:flat.size] = flat
                # one-shot shipping drops the error-feedback residual
                payload = QC.encode_flat(padded, block)[0].tobytes()
                fields.append({"t": t, "s": side,
                               "shape": list(arr.shape),
                               "numel": int(flat.size),
                               "nblocks": int(nblocks),
                               "bytes": len(payload)})
            else:
                payload = flat.tobytes()
                fields.append({"t": t, "s": side,
                               "shape": list(arr.shape),
                               "numel": int(flat.size),
                               "bytes": len(payload)})
            parts.append(payload)
    body = b"".join(parts)
    header = {"v": 1, "name": adapter.name, "rank": int(adapter.rank),
              "alpha": float(adapter.alpha),
              "adapter_version": int(adapter.version), "wire": wire,
              "fields": fields, "crc": zlib.crc32(body) & 0xFFFFFFFF}
    return json.dumps(header).encode("utf-8") + b"\n" + body


def unpack_adapter(blob: bytes) -> LoraAdapter:
    """Inverse of :func:`pack_adapter`. Raises
    :class:`AdapterCorruptError` on CRC or layout damage."""
    try:
        nl = blob.index(b"\n")
        header = json.loads(blob[:nl].decode("utf-8"))
        body = blob[nl + 1:]
    except (ValueError, UnicodeDecodeError) as e:
        raise AdapterCorruptError(f"unparseable adapter wire blob: {e}") \
            from e
    if (zlib.crc32(body) & 0xFFFFFFFF) != header.get("crc"):
        raise AdapterCorruptError(
            f"adapter wire CRC mismatch for {header.get('name')!r}")
    wire = header.get("wire", "raw")
    weights: Dict[str, Dict[str, np.ndarray]] = {}
    off = 0
    for fld in header["fields"]:
        raw = body[off:off + fld["bytes"]]
        off += fld["bytes"]
        numel = int(fld["numel"])
        if wire == "int8":
            block = QC.block_size()
            _, nblocks, wire_len = QC.wire_layout(numel, block)
            w8 = np.frombuffer(raw, np.int8)
            if w8.size != wire_len:
                raise AdapterCorruptError(
                    f"adapter q8 payload layout damaged for "
                    f"{header.get('name')!r}")
            flat = QC.decode_flat(w8, int(nblocks), block)[:numel]
        else:
            flat = np.frombuffer(raw, np.float32)
            if flat.size != numel:
                raise AdapterCorruptError(
                    f"adapter raw payload truncated for "
                    f"{header.get('name')!r}")
        arr = np.asarray(flat, np.float32).reshape(fld["shape"])
        weights.setdefault(fld["t"], {})[fld["s"]] = arr
    return LoraAdapter(
        name=str(header["name"]), rank=int(header["rank"]),
        alpha=float(header["alpha"]),
        version=int(header.get("adapter_version", 1)),
        weights={t: (w["A"], w["B"]) for t, w in weights.items()})


def _flip_tail(blob: bytes) -> bytes:
    """The chaos `adapter:corrupt` damage: flip the last body byte."""
    if not blob:
        return blob
    return blob[:-1] + bytes([blob[-1] ^ 0xFF])


class AdapterTransport:
    """Publish/fetch plane for adapter distribution: a store with
    ``set(key, bytes)`` / ``get(key) -> bytes`` (a
    ``torch.distributed.TCPStore`` when the fleet spans processes), or an
    in-process dict. The chaos ``adapter`` site drills both directions
    (``op=publish`` / ``op=fetch``)."""

    def __init__(self, store=None, prefix: str = "adapters"):
        self.store = store
        self.prefix = prefix
        self._local: Dict[str, bytes] = {}
        self.stats = {"publishes": 0, "fetches": 0, "wire_bytes": 0}

    def _key(self, name: str) -> str:
        return f"{self.prefix}/{name}"

    def publish(self, adapter: LoraAdapter,
                wire: Optional[str] = None) -> int:
        blob = pack_adapter(adapter, wire=wire)
        hook = _CHAOS_HOOK[0]
        if hook is not None and hook("publish", name=adapter.name) \
                == "corrupt":
            blob = _flip_tail(blob)
        if self.store is not None:
            self.store.set(self._key(adapter.name), blob)
        else:
            self._local[adapter.name] = blob
        self.stats["publishes"] += 1
        self.stats["wire_bytes"] += len(blob)
        return len(blob)

    def fetch(self, name: str) -> Optional[LoraAdapter]:
        """Pull and decode one adapter; None when unpublished; raises
        :class:`AdapterCorruptError` on wire damage."""
        if self.store is not None:
            # a TCPStore's get of a missing key waits out its timeout:
            # ask first where the store can say
            key = self._key(name)
            check = getattr(self.store, "check", None)
            if check is not None and not check([key]):
                return None
            try:
                blob = self.store.get(key)
            except Exception:  # noqa: BLE001 — an unpublished key
                blob = None
        else:
            blob = self._local.get(name)
        if blob is None:
            return None
        hook = _CHAOS_HOOK[0]
        if hook is not None and hook("fetch", name=name) == "corrupt":
            blob = _flip_tail(blob)
        self.stats["fetches"] += 1
        return unpack_adapter(bytes(blob))


# ---------------------------------------------------------------------------
# AdapterManager: paged, ref-counted, LRU-evictable device residency.
# ---------------------------------------------------------------------------

class _RankClassPack:
    """The stacked device tensors of one rank class: per target
    A [L, S, din, c], B [L, S, c, dout] f32, allocated on the class's
    first adapter and written in place from then on."""

    def __init__(self, cfg: L.LlamaConfig, cls: int, slots: int,
                 device: torch.device):
        self.cls = int(cls)
        self.slots = int(slots)
        self.slot_names: List[Optional[str]] = [None] * self.slots
        self.packs: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        for t, (din, dout) in target_dims(cfg).items():
            self.packs[t] = (
                torch.zeros((cfg.num_layers, self.slots, din, cls),
                            dtype=torch.float32, device=device),
                torch.zeros((cfg.num_layers, self.slots, cls, dout),
                            dtype=torch.float32, device=device))

    @property
    def nbytes_total(self) -> int:
        return int(sum(a.numel() * 4 + b.numel() * 4
                       for a, b in self.packs.values()))

    @property
    def nbytes_per_slot(self) -> int:
        return self.nbytes_total // max(1, self.slots)

    def write_slot(self, slot: int, adapter: LoraAdapter) -> None:
        """Load a slot in place: the rank padded to the class with zeros
        (the padded product is exact), a target the adapter lacks
        zero-filled (its delta is exactly 0.0)."""
        r = adapter.rank
        for t, (a_dev, b_dev) in self.packs.items():
            lw = adapter.weights.get(t)
            a_host = np.zeros(
                (a_dev.shape[0], a_dev.shape[2], self.cls), np.float32)
            b_host = np.zeros(
                (b_dev.shape[0], self.cls, b_dev.shape[3]), np.float32)
            if lw is not None:
                a_host[:, :, :r] = lw[0]
                b_host[:, :r, :] = lw[1]
            a_dev[:, slot].copy_(torch.from_numpy(a_host))
            b_dev[:, slot].copy_(torch.from_numpy(b_host))


class AdapterManager:
    """N LoRA adapters as paged device resources: :meth:`register` makes
    an adapter known (host copy), :meth:`pin`/:meth:`unpin` refcount it
    while requests are in flight, :meth:`ensure_loaded` places it in a
    device slot of its rank class, evicting the LRU refcount-0 resident
    when the class is full (:class:`NoAdapterSlotsError` when every slot
    is pinned). The host copy survives device eviction, so a chaos
    mid-stream evict reloads the same bits on the next tick."""

    def __init__(self, cfg: L.LlamaConfig, slots: int = DEFAULT_SLOTS,
                 device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError(f"adapter slots={self.slots} (want >= 1)")
        self._registry: Dict[str, LoraAdapter] = {}
        self._classes: Dict[int, _RankClassPack] = {}
        self._resident: Dict[str, Tuple[int, int]] = {}  # name -> (cls, slot)
        self._refs: Dict[str, int] = {}
        # refcount-0 residents in eviction order (oldest first)
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._ever_loaded: set = set()
        self.stats = {"registered": 0, "loads": 0, "swaps": 0,
                      "evictions": 0, "hits": 0, "pins": 0, "unpins": 0,
                      "prefetches": 0}

    # -- registry ---------------------------------------------------------
    def register(self, adapter: LoraAdapter) -> None:
        """Make an adapter known (host copy). Re-registering a name
        replaces the host copy and drops its device residency."""
        adapter.validate_for(self.cfg)
        if self._refs.get(adapter.name, 0) > 0:
            raise ValueError(
                f"adapter {adapter.name!r} is pinned by in-flight "
                f"requests; drain before replacing it")
        if adapter.name in self._resident:
            self.evict_device(adapter.name)
        self._registry[adapter.name] = adapter
        self.stats["registered"] += 1

    def registered(self, name: str) -> bool:
        return name in self._registry

    def names(self) -> List[str]:
        return sorted(self._registry)

    def get(self, name: str) -> LoraAdapter:
        a = self._registry.get(name)
        if a is None:
            raise AdapterMissingError(name)
        return a

    def has(self, name: str) -> bool:
        """Device-resident right now (the router's placement signal)."""
        return name in self._resident

    # -- refcounts --------------------------------------------------------
    def pin(self, name: str) -> None:
        """Take a reference for an in-flight request; an unknown name
        raises :class:`AdapterMissingError` before any count moves."""
        if name not in self._registry:
            raise AdapterMissingError(name)
        self._refs[name] = self._refs.get(name, 0) + 1
        self.stats["pins"] += 1
        self._lru.pop(name, None)   # a pinned resident is not evictable

    def unpin(self, name: str) -> None:
        n = self._refs.get(name, 0)
        if n <= 0:
            raise ValueError(f"unpin of unpinned adapter {name!r}")
        n -= 1
        self._refs[name] = n
        self.stats["unpins"] += 1
        if n == 0 and name in self._resident:
            self._lru[name] = None

    def ref_count(self, name: str) -> int:
        return self._refs.get(name, 0)

    # -- device residency -------------------------------------------------
    def ensure_loaded(self, name: str) -> Tuple[int, int]:
        """Place `name` in a device slot of its rank class, loading (and
        LRU-evicting) as needed. Returns (rank_class, slot)."""
        loc = self._resident.get(name)
        if loc is not None:
            self.stats["hits"] += 1
            return loc
        adapter = self.get(name)
        cls = rank_class(adapter.rank)
        pack = self._classes.get(cls)
        if pack is None:
            pack = _RankClassPack(self.cfg, cls, self.slots, self.device)
            self._classes[cls] = pack
        slot = next((s for s, n in enumerate(pack.slot_names)
                     if n is None), None)
        if slot is None:
            victim = next((n for n in self._lru
                           if self._resident.get(n, (None,))[0] == cls),
                          None)
            if victim is None:
                raise NoAdapterSlotsError(
                    f"all {self.slots} rank-{cls} adapter slots are "
                    f"pinned; raise adapter_slots or drain traffic")
            slot = self._resident[victim][1]
            self.evict_device(victim)
        pack.write_slot(slot, adapter)
        pack.slot_names[slot] = name
        self._resident[name] = (cls, slot)
        if self._refs.get(name, 0) == 0:
            self._lru[name] = None
        swap = name in self._ever_loaded
        self._ever_loaded.add(name)
        self.stats["loads"] += 1
        if swap:
            self.stats["swaps"] += 1
        return cls, slot

    def evict_device(self, name: str) -> bool:
        """Drop device residency (the host copy stays, so a later
        ensure_loaded reloads the same bits and counts a swap)."""
        loc = self._resident.pop(name, None)
        if loc is None:
            return False
        cls, slot = loc
        self._classes[cls].slot_names[slot] = None
        self._lru.pop(name, None)
        self.stats["evictions"] += 1
        return True

    def device_packs(self, cls: int) -> Dict[str, Tuple[torch.Tensor,
                                                         torch.Tensor]]:
        return self._classes[cls].packs

    # -- fleet distribution -----------------------------------------------
    def prefetch(self, name: str, transport: AdapterTransport) -> str:
        """Pull an unregistered adapter over a transport. Returns
        ``registered`` / ``ok`` / ``miss`` / ``corrupt``."""
        if name in self._registry:
            return "registered"
        self.stats["prefetches"] += 1
        try:
            adapter = transport.fetch(name)
        except AdapterCorruptError:
            return "corrupt"
        if adapter is None or adapter.name != name:
            return "miss"
        self.register(adapter)
        return "ok"

    # -- accounting -------------------------------------------------------
    def bytes_total(self) -> int:
        """Device bytes of every allocated rank-class pack (empty slots
        cost too, like the KV pool's free pages)."""
        return int(sum(p.nbytes_total for p in self._classes.values()))

    def bytes_in_use(self) -> int:
        """Device bytes behind occupied slots."""
        return int(sum(
            p.nbytes_per_slot * sum(n is not None for n in p.slot_names)
            for p in self._classes.values()))

    def num_resident(self) -> int:
        return len(self._resident)

    def snapshot(self) -> dict:
        return {
            "slots_per_class": self.slots,
            "registered": self.names(),
            "resident": {n: {"rank_class": c, "slot": s,
                             "refs": self._refs.get(n, 0)}
                         for n, (c, s) in sorted(self._resident.items())},
            "lru": list(self._lru),
            "bytes_in_use": self.bytes_in_use(),
            "bytes_total": self.bytes_total(),
            **{("registrations" if k == "registered" else k): v
               for k, v in self.stats.items()},
        }
