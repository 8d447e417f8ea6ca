"""K4's wide grouping kernel (``csrc/partition_wide.cu``, 257 to 8192
groups): a numpy emulation of its four launches held bit for bit against
K4's plain versions (``partition_slots_plain``, ``partition_scatter_plain``)
and a numpy stable oracle.

The emulation follows the kernel step by step: tiles of ``warps * 32 *
items`` ids; the count launch's chunks of tiles, each tile's 16-bit row of
the chunk's counts before it and each chunk's 32-bit word row; the carry
launch's chunk lanes, each summing a contiguous run of chunks, their
exclusive prefix, the rewritten chunk words and the exact totals; the group
starts and the pad slots before each layout region; the sweep's two stable
8-bit LSD digit passes over (group << index bits | local index), each warp
ranking its warp-striped items in input order and the per-warp digit counts
scanned digit-major; every group's base loaded at the tile's start and
the sorted index its first sorted item takes off it (modulo 2**32); the
clip; the slots staged at their input index; the
lanes staged through the inverse permutation; and each block's share of
the pad slots, found by binary search.  Small tiles make the inputs cross
tile, chunk and carry-lane boundaries; the kernel's own geometry runs at
one tile and its edges.  Tolerance 0 everywhere."""

import re
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join_torch.data.tuples import (lane_from_numpy,  # noqa: E402
                                              lane_to_numpy)
from tpu_radix_join_torch.ops.kernels import partition as k4  # noqa: E402

ONES = 0xFFFFFFFF
MASK32 = np.int64(ONES)
CSRC = Path(k4.__file__).resolve().parents[2] / "csrc" / "partition_wide.cu"


class Geometry(NamedTuple):
    warps: int
    items: int
    chunk: int          # tiles a count block takes
    carry_lanes: int    # chunk lanes of a carry block

    @property
    def tile(self) -> int:
        return 32 * self.warps * self.items

    @property
    def index_bits(self) -> int:
        return (self.tile - 1).bit_length()


KERNEL = Geometry(warps=16, items=16, chunk=k4.WIDE_CHUNK_TILES,
                  carry_lanes=32)
SMALL = Geometry(warps=2, items=2, chunk=3, carry_lanes=4)   # 128 ids a tile


def _stable_oracle(ids, num_groups, group_size, capacity, lanes=(),
                   fills=()):
    """K4's contract in numpy: (slots, hist, outs)."""
    g = np.where(ids < num_groups, ids, num_groups).astype(np.int64)
    full = np.bincount(g, minlength=num_groups + 1)
    start = np.cumsum(full) - full
    pos = np.empty(g.size, np.int64)
    pos[np.argsort(g, kind="stable")] = np.arange(g.size)
    keep = g < num_groups
    if capacity is None:
        slot = pos
    else:
        lead = (g // group_size) * group_size
        within = pos - start[np.minimum(lead, num_groups)]
        keep &= within < capacity
        slot = (g // group_size) * capacity + within
    slots = np.where(keep, slot, ONES).astype(np.uint32)
    size = k4.out_size(ids.size, num_groups, group_size, capacity)
    outs = []
    for lane, f in zip(lanes, fills):
        out = np.full(size, f, np.uint32)
        out[slots[keep].astype(np.int64)] = lane[keep]
        outs.append(out)
    return slots, full[:num_groups].astype(np.uint32), outs


# ---------------------------------------------------------- the emulation
def _count(ids, num_groups, geo):
    """count_kernel: (16-bit tile rows, 32-bit chunk words)."""
    n, tile = ids.size, geo.tile
    tiles = -(-n // tile)
    chunks = max(1, -(-tiles // geo.chunk))
    rows = np.zeros((tiles, num_groups), np.int64)
    words = np.zeros((chunks, num_groups), np.int64)
    for c in range(chunks):
        table = np.zeros(num_groups, np.int64)
        for t in range(c * geo.chunk, min(c * geo.chunk + geo.chunk, tiles)):
            rows[t] = table
            seg = ids[t * tile:(t + 1) * tile].astype(np.int64)
            table += np.bincount(seg[seg < num_groups], minlength=num_groups)
        words[c] = table
    assert rows.max(initial=0) < 1 << 16
    return rows.astype(np.uint16), words.astype(np.uint32)


def _carry(words, geo):
    """carry_kernel: (each chunk's words before it, the exact totals)."""
    chunks = words.shape[0]
    per = -(-chunks // geo.carry_lanes)
    w = words.astype(np.int64)
    part = [w[ty * per:min(chunks, (ty + 1) * per)].sum(0)
            for ty in range(geo.carry_lanes)]
    before = np.empty_like(w)
    run = np.zeros(w.shape[1], np.int64)
    for ty in range(geo.carry_lanes):
        r = run.copy()
        for c in range(ty * per, min(chunks, (ty + 1) * per)):
            before[c] = r
            r = (r + w[c]) & MASK32
        run = (run + part[ty]) & MASK32
    return before.astype(np.uint32), run.astype(np.uint32)


def _starts(totals, n, num_groups, group_size, capacity, pads):
    """starts_kernel: (starts [G + 1], pad_before [regions + 1] or None)."""
    starts = np.concatenate([[0], np.cumsum(totals.astype(np.int64))])
    if not pads:
        return starts, None
    if capacity is None:
        p = np.array([n - starts[num_groups]], np.int64)
    else:
        lead = starts[::group_size]
        count = lead[1:] - lead[:-1]
        p = capacity - np.minimum(count, capacity)
    return starts, np.concatenate([[0], np.cumsum(p)])


def _digit_pass(words, shift, bits, geo):
    """One stable LSD digit pass of the sweep over the tile's words in their
    current order: each warp ranks its warp-striped items in input order
    (the lanes whose digit's low ``bits`` bits match a lane's are its
    peers), the per-warp digit counts scan digit-major, and every word lands
    at its digit's offset plus its rank."""
    lanes = np.arange(32)
    below = lanes[None, :] < lanes[:, None]
    count = np.zeros((geo.warps, 256), np.int64)
    rank = np.empty(words.size, np.int64)
    digit = (words >> shift) & 255
    for w in range(geo.warps):
        for j in range(geo.items):
            at = slice((w * geo.items + j) * 32, (w * geo.items + j + 1) * 32)
            d = digit[at]
            m = d & ((1 << bits) - 1)
            peers = m[None, :] == m[:, None]
            rank[at] = count[w, d] + (peers & below).sum(1)
            leader = np.argmax(peers, axis=1) == lanes
            np.add.at(count[w], d[leader], peers[leader].sum(1))
    offset = (np.cumsum(count.T.reshape(-1)) - count.T.reshape(-1)).reshape(
        256, geo.warps).T
    out = np.empty_like(words)
    warp = np.arange(words.size) // (32 * geo.items)
    out[offset[warp, digit] + rank] = words
    return out


def _sweep_tile(ids, t, num_groups, group_size, capacity, rows, before,
                starts, geo):
    """The sweep's tile t: (local indices, sorted indices, slots) of every
    id of the tile, past-n rows included (their slot is dropped)."""
    n, tile, ib = ids.size, geo.tile, geo.index_bits
    k = np.arange(tile, dtype=np.int64)
    i = t * tile + k
    g = np.full(tile, num_groups, np.int64)
    inside = i < n
    got = ids[i[inside]].astype(np.int64)
    g[inside] = np.where(got < num_groups, got, num_groups)
    words = g << ib | k
    high_bits = (num_groups >> 8).bit_length()
    words = _digit_pass(words, ib, 8, geo)
    words = _digit_pass(words, ib + 8, high_bits, geo)
    sg, sk = words >> ib, words & (tile - 1)
    s = np.arange(tile, dtype=np.int64)
    # every group's base, loaded at the tile's start; the first of each
    # group in the sorted tile takes its sorted index off it
    g_all = np.arange(num_groups)
    lead = (np.zeros(num_groups, np.int64) if capacity is None
            else starts[(g_all // group_size) * group_size])
    base = (starts[:num_groups] + before[t // geo.chunk].astype(np.int64)
            + rows[t].astype(np.int64) - lead) & MASK32
    first = (sg < num_groups) & np.concatenate([[True], sg[1:] != sg[:-1]])
    base[sg[first]] = (base[sg[first]] - s[first]) & MASK32
    dst = np.full(tile, ONES, np.int64)
    real = sg < num_groups
    pos = (base[sg[real]] + s[real]) & MASK32
    if capacity is None:
        dst[real] = pos
    else:
        keep = pos < capacity
        d = np.full(pos.size, ONES, np.int64)
        d[keep] = (sg[real][keep] // group_size) * capacity + pos[keep]
        dst[real] = d
    return sk, s, dst


def _pads(outs, fills, pad_before, n, num_groups, group_size, capacity,
          blocks):
    """Each block's share of the pad slots, from the binary-searched last
    region whose pads start at or before its first."""
    regions = 1 if capacity is None else num_groups // group_size
    total = int(pad_before[regions])
    share = -(-total // blocks)
    for blk in range(blocks):
        lo, hi = blk * share, min(blk * share + share, total)
        if lo >= hi:
            continue
        b, top = 0, regions - 1
        while b < top:
            mid = (b + top + 1) >> 1
            if pad_before[mid] <= lo:
                b = mid
            else:
                top = mid - 1
        for b in range(b, regions):
            pb, pe = int(pad_before[b]), int(pad_before[b + 1])
            if pb >= hi:
                break
            if pe <= lo:
                continue
            end = n if capacity is None else (b + 1) * capacity
            first = end - (pe - pb)
            x = np.arange(max(lo, pb) - pb, min(hi, pe) - pb) + first
            for out, f in zip(outs, fills):
                out[x] = f


def _wide_emulation(ids, num_groups, group_size, capacity, lanes=(),
                    fills=(), geo=KERNEL):
    """The four launches of ``rj_partition_wide``: (slots, hist, outs)."""
    n, tile = ids.size, geo.tile
    rows, words = _count(ids, num_groups, geo)
    before, totals = _carry(words, geo)
    starts, pad_before = _starts(totals, n, num_groups, group_size, capacity,
                                 pads=bool(lanes))
    tiles = rows.shape[0]
    size = k4.out_size(n, num_groups, group_size, capacity)
    slots = np.empty(n, np.uint32)
    # the outputs start as garbage: every slot must be written
    outs = [np.full(size, 0xDEADBEEF, np.uint32) for _ in lanes]
    for t in range(tiles):
        sk, s, dst = _sweep_tile(ids, t, num_groups, group_size, capacity,
                                 rows, before, starts, geo)
        stage = np.empty(tile, np.int64)
        stage[sk] = dst                           # slots mode
        inside = t * tile + np.arange(tile) < n
        slots[t * tile + np.flatnonzero(inside)] = stage[inside]
        inverse = np.empty(tile, np.int64)
        inverse[sk] = s                           # moving mode
        for lane, out in zip(lanes, outs):
            staged = np.zeros(tile, np.uint32)
            staged[inverse[inside]] = lane[t * tile + np.flatnonzero(inside)]
            w = dst != ONES
            out[dst[w]] = staged[w]
    if lanes:
        pad_slots = 4 * tile
        blocks = max(tiles, -(-size // pad_slots), 1)
        _pads(outs, fills, pad_before, n, num_groups, group_size, capacity,
              blocks)
    return slots, totals, outs


# ------------------------------------------------------------------ cases
def _ids(kind, n, groups, gsize, rng):
    if kind == "random":
        return rng.integers(0, groups + groups // 8, n).astype(np.uint32)
    if kind == "hot":                 # one group across every tile
        ids = rng.integers(0, groups, n).astype(np.uint32)
        ids[rng.random(n) < 0.7] = gsize // 2
        return ids
    if kind == "one_group":
        return np.full(n, groups - 1, np.uint32)
    if kind == "invalid":             # every id dropped
        ids = rng.integers(groups, 1 << 32, n, dtype=np.uint64)
        ids[:1] = groups
        return ids.astype(np.uint32)
    if kind == "sorted":
        return np.sort(rng.integers(0, groups, n)).astype(np.uint32)
    raise ValueError(kind)


CASES = [   # id, n, groups, group_size, capacity, kind, geometry
    ("g257", 3000, 257, 1, None, "random", SMALL),
    ("g1025", 3000, 1025, 1, None, "random", SMALL),
    ("g4097", 3000, 4097, 1, None, "random", SMALL),
    ("g8192_cap", 3000, k4.WIDE_MAX_GROUPS, 1, None, "random", SMALL),
    ("grouped_16x32", 3000, 16 * 32, 32, 60, "hot", SMALL),
    ("grouped_4x256", 3000, 4 * 256, 256, 500, "hot", SMALL),
    ("n1", 1, 1025, 1, None, "random", SMALL),
    ("n_tile_less_1", 127, 1025, 1, None, "random", SMALL),
    ("n_tile", 128, 1025, 1, None, "random", SMALL),
    ("n_tile_plus_1", 129, 1025, 1, None, "random", SMALL),
    ("n_chunk_plus_1", 3 * 128 + 1, 1024, 32, 9, "random", SMALL),
    ("hot_group", 3000, 1025, 1, None, "hot", SMALL),
    ("one_group", 3000, 4097, 1, None, "one_group", SMALL),
    ("all_invalid_dense", 3000, 1025, 1, None, "invalid", SMALL),
    ("all_invalid_blocked", 700, 512, 32, 7, "invalid", SMALL),
    ("capacity_1", 3000, 4097, 1, 1, "random", SMALL),
    ("sorted", 3000, 1025, 1, None, "sorted", SMALL),
    ("sorted_blocked", 3000, 1024, 256, 400, "sorted", SMALL),
    ("kernel_tile_less_1", KERNEL.tile - 1, 1025, 1, None, "random",
     KERNEL),
    ("kernel_tile", KERNEL.tile, 4097, 1, None, "hot", KERNEL),
    ("kernel_tile_plus_1", KERNEL.tile + 1, 512, 32, 300, "hot", KERNEL),
]


@pytest.mark.parametrize("case,n,groups,gsize,cap,kind,geo", CASES,
                         ids=[c[0] for c in CASES])
def test_wide_emulation_equals_the_plain_versions(case, n, groups, gsize,
                                                  cap, kind, geo):
    """Slots, totals and two moved lanes with their pad fills: the
    emulation, K4's plain versions and the stable oracle agree bit for
    bit."""
    rng = np.random.default_rng(sum(map(ord, case)))
    ids = _ids(kind, n, groups, gsize, rng)
    key = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    rid = np.arange(n, dtype=np.uint32)
    fills = (ONES, 7)
    want_slots, want_hist, want_outs = _stable_oracle(
        ids, groups, gsize, cap, (key, rid), fills)
    slots, hist, outs = _wide_emulation(ids, groups, gsize, cap, (key, rid),
                                        fills, geo)
    np.testing.assert_array_equal(slots, want_slots)
    np.testing.assert_array_equal(hist, want_hist)
    for got, want in zip(outs, want_outs):
        np.testing.assert_array_equal(got, want)
    t_ids = lane_from_numpy(ids, "cpu")
    p_slots, p_hist = k4.partition_slots_plain(t_ids, groups, gsize, cap)
    np.testing.assert_array_equal(lane_to_numpy(p_slots), slots)
    np.testing.assert_array_equal(lane_to_numpy(p_hist), hist)
    p_outs, _ = k4.partition_scatter_plain(
        t_ids, [lane_from_numpy(key, "cpu"), lane_from_numpy(rid, "cpu")],
        fills, groups, gsize, cap)
    for got, want in zip(p_outs, outs):
        np.testing.assert_array_equal(lane_to_numpy(got), want)


def test_digit_pass_is_stable_and_groups_by_the_digit():
    """One pass over a tile of repeated digits keeps input order within a
    digit, across warps and items."""
    geo = SMALL
    rng = np.random.default_rng(3)
    words = rng.integers(0, 5, geo.tile).astype(np.int64) << 8 | np.arange(
        geo.tile)
    out = _digit_pass(words, 8, 8, geo)
    np.testing.assert_array_equal(out, words[np.argsort(words >> 8,
                                                         kind="stable")])


def test_carry_lanes_cross_chunk_runs():
    """More chunks than carry lanes and fewer: each chunk's words before
    it and the totals equal a plain cumulative sum."""
    rng = np.random.default_rng(4)
    for chunks in (1, 3, 4, 5, 17):
        words = rng.integers(0, 1000, (chunks, 9)).astype(np.uint32)
        before, totals = _carry(words, SMALL)
        w = words.astype(np.int64)
        np.testing.assert_array_equal(before, np.cumsum(w, 0) - w)
        np.testing.assert_array_equal(totals, w.sum(0))


@pytest.mark.parametrize("groups,path", [
    (k4.MAX_GROUPS, "onesweep"), (k4.MAX_GROUPS + 1, "wide"),
    (4097, "wide"), (k4.WIDE_MAX_GROUPS, "wide"),
    (k4.WIDE_MAX_GROUPS + 1, "msd"), (65537, "msd")])
def test_the_group_count_alone_picks_the_card_path(monkeypatch, groups, path):
    """The onesweep call up to 256 groups, the wide kernel up to the cap,
    the MSD passes past it."""
    called = []
    monkeypatch.setattr(k4, "_partition_cuda", lambda *a, wide=False:
                        called.append("wide" if wide else "onesweep"))
    monkeypatch.setattr(k4, "_partition_msd_cuda",
                        lambda *a: called.append("msd"))
    k4._grouping_cuda(None, groups, 1, None, [], [], True)
    assert called == [path]


def test_wide_constants_match_the_kernel_source():
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([^;]+);",
                             src).group(1).split()[0])

    assert const("kMaxGroups") == k4.WIDE_MAX_GROUPS
    assert const("kChunk") == k4.WIDE_CHUNK_TILES
    assert const("kThreads") == 32 * KERNEL.warps
    assert const("kItems") == KERNEL.items
    assert KERNEL.tile == k4.WIDE_TILE_IDS == 1 << const("kIndexBits")


def test_wide_scratch_sizes_stated_in_perf():
    """The count matrix at 20M ids (PERF.md §6: 7,511,208 bytes at 1025
    groups, 30,022,824 at 4097) and the whole scratch."""
    lay = k4.wide_scratch_layout(20_000_000, 1025)
    assert (lay.tiles, lay.chunks, lay.regions) == (2442, 611, 1)
    assert lay.matrix_bytes == 7_511_208
    assert lay.bytes == 7_511_208 + 16 + 4104 + 4104
    assert k4.wide_scratch_layout(20_000_000, 4097).matrix_bytes == 30_022_824
    grouped = k4.wide_scratch_layout(20_000_000, 1024, 256, 1 << 23)
    assert grouped.regions == 4 and grouped.totals_offset == (40 + 4104) // 4
    assert k4.wide_scratch_layout(0, 300).chunks == 1
    rows, words = _count(np.zeros(3 * 128 + 1, np.uint32), 300, SMALL)
    small = k4.WideScratchLayout(tiles=4, chunks=2, num_groups=300,
                                 regions=1)
    assert (rows.shape[0], words.shape[0]) == (small.tiles, small.chunks)
    with pytest.raises(ValueError):
        k4.wide_scratch_layout(1 << 32, 300)
    with pytest.raises(ValueError):
        k4.wide_scratch_layout(10, k4.WIDE_MAX_GROUPS + 1)
