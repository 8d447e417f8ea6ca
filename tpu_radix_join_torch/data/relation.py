"""Relations and seeded data generation with closed-form correctness oracles.

Counterpart of ``tpu_radix_join/data/relation.py``.  A :class:`Relation` is
a spec; :meth:`Relation.generate` materialises it on a device, bit-identical
to the JAX package's device generators for the same spec:

  * ``unique`` — a seeded 6-round Feistel permutation of [0, global_size)
    with cycle-walking; the round keys come from numpy's ``default_rng``,
    exactly as the JAX package draws them.
  * ``modulo`` — ``key = rid % modulo``.
  * ``zipf``   — Zipf(1 + theta) draws over [0, key_domain) from integer
    tables built once on the host (:func:`zipf_tables`, copied verbatim),
    then pure uint32 arithmetic.

``rid`` is the dense global tuple index.  :meth:`Relation.shard` generates
node i's slice, the global index range ``[i * local, (i + 1) * local)``,
as the JAX package's ``shard_np`` / ``shard`` do; :meth:`Relation.generate`
the whole relation.  ``key_bits=64`` adds the hi lane
:func:`key_hi_lane` of each key.  Generation is plain PyTorch on int64
tensors holding uint32 values; the lanes it returns are int32
(data/tuples.py).

The host arms (:meth:`Relation.fill_np`, :meth:`Relation.shard_np`)
fill uint32 numpy arrays through the native multithreaded generators
(``native/datagen.cc``, built at first use; a failed build raises),
bit-identical to the device arms.  The JAX package's numpy generators,
copied (:func:`feistel_permutation_np`, :func:`zipf_keys_np`,
:func:`key_hi_lane_np`), are their plain versions, which the tests hold
them against.  ``JoinConfig(generation="host")`` places relations through
them, and the host-fed chunk stream (data/streaming.py) fills its pinned
buffers with them.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from tpu_radix_join_torch.core.device import resolve_device
from tpu_radix_join_torch.data.tuples import TupleBatch, narrow
from tpu_radix_join_torch.utils.hashing import mix32, mix32_np

_FEISTEL_ROUNDS = 6
_ZIPF_TABLE_MAX = 65536
ZIPF_TAIL_POINTS = 4096
_ZIPF_V_SALT = 0x9E3779B9   # second-draw salt for the tail interpolation
_U32 = 0xFFFFFFFF
# 64-bit keys: the hi lane is a fixed, unseeded mix of the 32-bit logical
# key, the same for every relation, so equal logical keys stay equal wide
# keys and every closed-form oracle carries over.  It lies in [2**30,
# 2**31): every wide key is above 2**62, and the sentinel lane (key_hi for
# wide batches) never meets the 0xFFFFFFFE/0xFFFFFFFF pads.
_HI_LANE_LOW = 0x40000000
_HI_LANE_MASK = 0x3FFFFFFF


def key_hi_lane(key: torch.Tensor) -> torch.Tensor:
    """int64 hi lane of int64 keys in [0, 2**32): ``(mix32(key) &
    0x3FFFFFFF) | 0x40000000``."""
    return (mix32(key) & _HI_LANE_MASK) | _HI_LANE_LOW


def key_hi_lane_np(key: np.ndarray) -> np.ndarray:
    """uint32 hi lane of uint32 keys: the numpy twin of
    :func:`key_hi_lane`."""
    return ((mix32_np(key) & np.uint32(_HI_LANE_MASK))
            | np.uint32(_HI_LANE_LOW))


def zipf_tables(theta: float, domain: int):
    """Integer-scaled Zipf(1+theta) sampling tables (host float64, once):
    ``head_cdf`` uint32 [min(domain, 65536)], the rank CDF scaled to 2**32,
    and ``tail_keys`` uint32 [4097], the piecewise-linear inverse CDF of the
    power-law tail past the head table."""
    table = min(domain, _ZIPF_TABLE_MAX)
    ranks = np.arange(1, table + 1, dtype=np.float64)
    cdf = np.cumsum(1.0 / np.power(ranks, 1.0 + theta))
    head = cdf[-1]
    t_pow = float(table) ** -theta
    d_pow = float(domain) ** -theta
    tail = (t_pow - d_pow) / theta if domain > table else 0.0
    total = head + tail
    head_cdf = np.minimum(np.floor(cdf / total * 4294967296.0),
                          4294967295.0).astype(np.uint32)
    if domain > table:
        f = (np.arange(ZIPF_TAIL_POINTS + 1, dtype=np.float64)
             / ZIPF_TAIL_POINTS)
        x = np.power(t_pow - f * (t_pow - d_pow), -1.0 / theta)
        tail_keys = np.clip(np.floor(x), table, domain - 1).astype(np.uint32)
    else:
        # unused (no tail); a constant table keeps every sampler shape-stable
        tail_keys = np.full(ZIPF_TAIL_POINTS + 1, table - 1, np.uint32)
    return head_cdf, tail_keys


def zipf_range(start: int, n: int, head_cdf: np.ndarray,
               tail_keys: np.ndarray, domain: int, seed: int,
               device) -> torch.Tensor:
    """int64 Zipf keys for global indices [start, start + n): u = mix32(index
    ^ mix32(seed)); head ranks by upper-bound search of the scaled CDF;
    tail ranks by linear interpolation of ``tail_keys`` with a second mixed
    draw supplying (segment, fraction) bits."""
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    cdf = torch.from_numpy(head_cdf.astype(np.int64)).to(device)
    table = cdf.numel()
    u = mix32(idx ^ mix32(torch.tensor(seed & _U32, dtype=torch.int64,
                                       device=device)))
    key = torch.clamp(torch.searchsorted(cdf, u, right=True), max=table - 1)
    if domain > table:
        tk_all = torch.from_numpy(tail_keys.astype(np.int64)).to(device)
        v = mix32(u ^ _ZIPF_V_SALT)
        j = v >> 20
        frac = (v >> 8) & 0xFFF
        tk = tk_all[j]
        d = (tk_all[j + 1] - tk) & _U32
        interp = ((d >> 12) * frac + (((d & 0xFFF) * frac) >> 12)) & _U32
        s = (tk + interp) & _U32
        # uint32-wrap clamp (domain may sit within 4093 of 2**32): a
        # wrapped sum shows as s < tk
        k_tail = torch.where(s < tk, torch.full_like(s, domain - 1),
                             torch.clamp(s, max=domain - 1))
        key = torch.where(u >= cdf[table - 1], k_tail, key)
    return key


def zipf_keys_np(start: int, count: int, head_cdf: np.ndarray,
                 tail_keys: np.ndarray, domain: int, seed: int) -> np.ndarray:
    """uint32 Zipf keys for global indices [start, start + count): the
    numpy twin of :func:`zipf_range`, the same uint32 operations on the
    same tables."""
    table = len(head_cdf)
    idx = np.arange(start, start + count, dtype=np.uint32)
    with np.errstate(over="ignore"):
        u = mix32_np(idx ^ mix32_np(np.uint32(seed & _U32)))
        key = np.minimum(
            np.searchsorted(head_cdf, u, side="right"),
            table - 1).astype(np.uint32)
        if domain > table:
            v = mix32_np(u ^ np.uint32(_ZIPF_V_SALT))
            j = (v >> np.uint32(20)).astype(np.int64)
            frac = (v >> np.uint32(8)) & np.uint32(0xFFF)
            tk = tail_keys[j]
            d = tail_keys[j + 1] - tk
            interp = ((d >> np.uint32(12)) * frac
                      + (((d & np.uint32(0xFFF)) * frac) >> np.uint32(12)))
            s = tk + interp
            # uint32-wrap clamp, as on the device
            k_tail = np.where(s < tk, np.uint32(domain - 1),
                              np.minimum(s, np.uint32(domain - 1)))
            key = np.where(u >= head_cdf[-1], k_tail, key)
    return key


def _feistel_round_np(left, right, k, half_bits):
    mask = (1 << half_bits) - 1
    f = ((right * 0x9E3779B1 + k) ^ (right >> 7)) & mask
    return right, (left ^ f) & mask


def feistel_permutation_np(idx: np.ndarray, domain_bits: int,
                           seed: int) -> np.ndarray:
    """Seeded bijection on [0, 2**(2*half)) of uint64 numpy indices: the
    numpy twin of :func:`_feistel`, the same round keys."""
    half = (domain_bits + 1) // 2
    mask = (1 << half) - 1
    left = (idx >> half).astype(np.uint64)
    right = (idx & mask).astype(np.uint64)
    keys = np.random.default_rng(seed).integers(
        0, 1 << 31, size=_FEISTEL_ROUNDS, dtype=np.uint64)
    for i in range(_FEISTEL_ROUNDS):
        left, right = _feistel_round_np(left, right, keys[i], half)
    out = (left << half) | right
    return out & ((1 << (2 * half)) - 1)


def _feistel_keys(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 1 << 31, size=_FEISTEL_ROUNDS, dtype=np.uint32)


def _feistel(idx: torch.Tensor, round_keys, domain_bits: int) -> torch.Tensor:
    """Seeded bijection on [0, 2**(2*half)) for int64 ``idx``.  ``r`` stays
    below 2**16, so ``r * 0x9E3779B1 + k`` fits int64; its uint32 wrap on
    the TPU only touches bits the half mask drops."""
    half = (domain_bits + 1) // 2
    mask = (1 << half) - 1
    left = idx >> half
    right = idx & mask
    for k in round_keys:
        f = ((right * 0x9E3779B1 + int(k)) ^ (right >> 7)) & mask
        left, right = right, (left ^ f) & mask
    return (left << half) | right


def unique_keys(start: int, n: int, global_size: int, seed: int,
                device) -> torch.Tensor:
    """int64 shard [start, start + n) of a seeded permutation of
    [0, global_size): Feistel over the next power-of-two domain, re-walking
    the values that land outside [0, global_size) until none does."""
    domain_bits = max(2, (global_size - 1).bit_length())
    rk = _feistel_keys(seed)
    v = _feistel(torch.arange(start, start + n, dtype=torch.int64,
                              device=device), rk, domain_bits)
    while bool((v >= global_size).any()):
        v = torch.where(v < global_size, v, _feistel(v, rk, domain_bits))
    return v


class Relation:
    """A logical relation: a global keyspace spec plus its generator.

    ``num_nodes`` splits it into equal shards, one a rank (:meth:`shard`).
    ``key_bits=64`` adds the hi lane."""

    def __init__(
        self,
        global_size: int,
        num_nodes: int = 1,
        kind: str = "unique",
        seed: int = 1234,
        key_bits: int = 32,
        modulo: Optional[int] = None,
        zipf_theta: Optional[float] = None,
        key_domain: Optional[int] = None,
    ):
        if global_size % num_nodes != 0:
            raise ValueError("global_size must divide evenly across nodes")
        if kind not in ("unique", "modulo", "zipf"):
            raise ValueError(f"unknown relation kind {kind!r}")
        if kind == "modulo" and not modulo:
            raise ValueError("modulo kind requires modulo=")
        if kind == "zipf" and (zipf_theta is None or zipf_theta <= 0):
            raise ValueError("zipf kind requires zipf_theta= > 0")
        if key_bits not in (32, 64):
            raise ValueError("key_bits must be 32 or 64")
        if key_bits == 32 and global_size > (1 << 31) - 2:
            raise ValueError(
                "32-bit keys cap global_size at 2**31 - 2 (31-bit merge-count "
                "packing + sentinel headroom); use key_bits=64 beyond that")
        if key_bits == 64 and global_size > (1 << 32) - 1:
            raise ValueError(
                "global_size caps at 2**32 - 1 (dense uint32 rids)")
        self.global_size = int(global_size)
        self.num_nodes = int(num_nodes)
        self.kind = kind
        self.seed = int(seed)
        self.key_bits = int(key_bits)
        self.modulo = modulo
        self.zipf_theta = zipf_theta
        self.key_domain = int(key_domain) if key_domain else self.global_size
        self._zipf_cache = None

    def _zipf_tables_cached(self):
        if self._zipf_cache is None:
            self._zipf_cache = zipf_tables(self.zipf_theta, self.key_domain)
        return self._zipf_cache

    @property
    def local_size(self) -> int:
        return self.global_size // self.num_nodes

    def key_bound(self) -> int:
        """Exclusive static upper bound on generated key values (the input
        of ``key_range="auto"``); 2**64 for 64-bit keys, whose hi lane
        spans [2**30, 2**31)."""
        if self.key_bits == 64:
            return 1 << 64
        if self.kind == "unique":
            return self.global_size
        if self.kind == "modulo":
            return min(self.modulo, self.global_size)
        return self.key_domain

    def keys_range(self, start: int, n: int, device) -> torch.Tensor:
        """int64 keys of the global index range [start, start + n)."""
        if self.kind == "unique":
            return unique_keys(start, n, self.global_size, self.seed, device)
        if self.kind == "modulo":
            return torch.arange(start, start + n, dtype=torch.int64,
                                device=device) % self.modulo
        head_cdf, tail_keys = self._zipf_tables_cached()
        return zipf_range(start, n, head_cdf, tail_keys, self.key_domain,
                          self.seed, device)

    def fill_np(self, start: int, count: int, num_threads: int = 0,
                out_key: Optional[np.ndarray] = None,
                out_rid: Optional[np.ndarray] = None):
        """(keys, rids), uint32 numpy arrays of the global index range
        [start, start + count), bit-identical to the device lanes, filled
        by the native generators on ``num_threads`` threads (0: up to 16,
        one a core; at most one a 2**16 keys).  ``out_key`` / ``out_rid`` (contiguous uint32
        [count], pool views from ``memory.Pool.get_array`` in the chunk
        stream) are filled in place when given."""
        from tpu_radix_join_torch.native.build import load
        lo, n = int(start), int(count)

        def buf(out):
            if out is None:
                return np.empty(n, dtype=np.uint32)
            if (out.shape != (n,) or out.dtype != np.uint32
                    or not out.flags.c_contiguous):
                raise ValueError(f"out buffer must be contiguous uint32 [{n}]")
            return out

        key, rid = buf(out_key), buf(out_rid)
        lib = load()
        if num_threads <= 0:
            num_threads = min(16, os.cpu_count() or 1)
        # a thread a 2**16 keys at least: a small fill starts no idle ones
        num_threads = max(1, min(num_threads, -(-n // (1 << 16))))
        p_u32 = ctypes.POINTER(ctypes.c_uint32)
        kp = key.ctypes.data_as(p_u32)
        lib.fill_rids(rid.ctypes.data_as(p_u32), lo, n, num_threads)
        if self.kind == "unique":
            domain_bits = max(2, (self.global_size - 1).bit_length())
            rk = np.ascontiguousarray(_feistel_keys(self.seed))
            lib.fill_unique(kp, lo, n, self.global_size,
                            (domain_bits + 1) // 2, rk.ctypes.data_as(p_u32),
                            num_threads)
        elif self.kind == "modulo":
            lib.fill_modulo(kp, lo, n, self.modulo, num_threads)
        else:
            head_cdf, tail_keys = self._zipf_tables_cached()
            lib.fill_zipf(kp, lo, n, head_cdf.ctypes.data_as(p_u32),
                          len(head_cdf), tail_keys.ctypes.data_as(p_u32),
                          self.key_domain, self.seed, num_threads)
        return key, rid

    def shard_np(self, node: int, num_threads: int = 0):
        """Node ``node``'s shard as uint32 numpy arrays: ``(keys, rids)``,
        or ``(keys_lo, keys_hi, rids)`` for 64-bit keys (the JAX package's
        ``shard_np`` contract), generated on ``num_threads`` threads."""
        if not 0 <= node < self.num_nodes:
            raise ValueError(f"node must be in [0, {self.num_nodes}), got "
                             f"{node}")
        key, rid = self.fill_np(node * self.local_size, self.local_size,
                                num_threads)
        if self.key_bits == 64:
            return key, key_hi_lane_np(key), rid
        return key, rid

    def _batch(self, start: int, n: int, device) -> TupleBatch:
        dev = resolve_device(device)
        key = self.keys_range(start, n, dev)
        rid = torch.arange(start, start + n, dtype=torch.int64, device=dev)
        hi = narrow(key_hi_lane(key)) if self.key_bits == 64 else None
        return TupleBatch(key=narrow(key), rid=narrow(rid), key_hi=hi)

    def generate(self, device="cuda") -> TupleBatch:
        """The whole relation as a TupleBatch on ``device`` (cuda unless the
        caller asks for cpu); 64-bit relations carry ``key_hi``."""
        return self._batch(0, self.global_size, device)

    def shard(self, node: int, device="cuda") -> TupleBatch:
        """Node ``node``'s shard, global indices ``[node * local_size,
        (node + 1) * local_size)``: the JAX package's ``shard_np(node)``
        (``relation.py:426-467``) as a TupleBatch on ``device``."""
        if not 0 <= node < self.num_nodes:
            raise ValueError(f"node must be in [0, {self.num_nodes}), got "
                             f"{node}")
        return self._batch(node * self.local_size, self.local_size, device)

    def expected_matches(self, outer: "Relation") -> Optional[int]:
        """Closed-form expected |self ⋈ outer| where derivable: unique ⋈
        unique over the same range -> global_size; unique ⋈ modulo/zipf with
        the outer key domain covered by the unique range -> outer size.
        None when no closed form applies."""
        if self.kind != "unique":
            return None
        if outer.kind == "unique" and outer.global_size == self.global_size:
            return self.global_size
        if outer.kind == "modulo" and outer.modulo <= self.global_size:
            return outer.global_size
        if outer.kind == "zipf" and outer.key_domain <= self.global_size:
            return outer.global_size
        return None


def host_join_count(r_keys: np.ndarray, s_keys: np.ndarray) -> int:
    """O((n+m) log) host oracle join count for tests without a closed form.
    The outer keys are sorted too, so numpy's binary searches walk their
    needles in order: unsorted needles miss the cache at every step (at
    20M tuples a side, 20 s against 2 s on the card's host)."""
    r_sorted = np.sort(r_keys)
    s_sorted = np.sort(s_keys)
    lo = np.searchsorted(r_sorted, s_sorted, side="left")
    hi = np.searchsorted(r_sorted, s_sorted, side="right")
    return int((hi - lo).sum())
