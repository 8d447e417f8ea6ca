"""The packed wire codec and the staged exchange of the port (ROADMAP A13)
against the JAX package, bit for bit.

  * ``data/tuples.pack_blocks`` words and ``unpack_blocks`` lanes over the
    key width x fanout 0-5 x bound grid of ``tests/test_exchange_codec.py``,
    the outer sentinels, the ``WireSpec`` geometry and its errors;
  * ``ops/radix.scatter_to_blocks_grouped`` (K4's grouped mode) against
    JAX's Pallas interpret and loop arms, and its refusal past 256 groups;
  * ``parallel/window``: ``parse_exchange_mode``; the staged
    ``block_all_to_all`` against the fused route and JAX's, flat and
    hierarchical; the pack window against the off window and JAX's, over
    one 4-process gloo world (tests/torch_dist_worker.py);
  * whole joins at four ranks under pack, auto and staged (narrow, 64-bit,
    the skew split, the bucket path, ``join_materialize``, two hosts)
    against ``jx.HashJoin(num_nodes=4)``, with ``meta["exchange_plan"]``,
    WIREBYTES, PACKRATIO and XSTAGES;
  * ``distribute`` staged, the configuration and the CLI flags.

Tolerance 0 everywhere.  One world serves the module."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import tpu_radix_join as jx  # noqa: E402
from tpu_radix_join.data import tuples as JT  # noqa: E402
from tpu_radix_join.ops import radix as jradix  # noqa: E402
from tpu_radix_join.parallel import window as jwindow  # noqa: E402
from tpu_radix_join.parallel.distribute import (  # noqa: E402
    distribute as j_distribute)
from tpu_radix_join.parallel.mesh import (  # noqa: E402
    make_hierarchical_mesh, make_mesh)
from tpu_radix_join.parallel.network_partitioning import (  # noqa: E402
    network_partition as j_network_partition)
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)

import tpu_radix_join_torch as tx  # noqa: E402
from tpu_radix_join_torch.data import tuples as TT  # noqa: E402
from tpu_radix_join_torch.data.tuples import (  # noqa: E402
    lane_from_numpy, lane_to_numpy)
from tpu_radix_join_torch.ops.radix import (  # noqa: E402
    scatter_to_blocks_grouped)
from tpu_radix_join_torch.parallel import window as twindow  # noqa: E402
from tpu_radix_join_torch.state import config_from_jax  # noqa: E402
from torch_dist_worker import WorkerPool  # noqa: E402

N = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_codec_world"))
    yield pool
    pool.close()


def _lane(a):
    return lane_from_numpy(np.asarray(a, np.uint32), "cpu")


def _np(t):
    return lane_to_numpy(t)


# ------------------------------------------------------------ codec core
def _contract_blocks(rng, spec, key_space, nb):
    """``tests/test_exchange_codec._contract_blocks``: blocks honouring the
    grouped scatter's contract (valid tuples at the front, sorted by pid),
    one full and one empty, every pad slot all-ones garbage."""
    cap = spec.capacity
    mask = spec.num_sub - 1
    counts = [cap, 0] + list(rng.integers(1, cap, nb - 2))
    keys = np.full(nb * cap, (1 << 64) - 1, np.uint64)
    rids = np.full(nb * cap, 0xFFFFFFFF, np.uint64)
    group_counts = np.zeros((nb, spec.num_sub), np.uint32)
    for b, cnt in enumerate(counts):
        k = rng.integers(0, key_space, cnt, dtype=np.uint64)
        if cnt:
            k[0] = key_space - 1          # the exact bound edge
        pid = (k & np.uint64(mask)).astype(np.uint32)
        order = np.argsort(pid, kind="stable")
        keys[b * cap:b * cap + cnt] = k[order]
        rids[b * cap:b * cap + cnt] = rng.integers(0, 1 << 20, cnt,
                                                   dtype=np.uint64)
        group_counts[b] = np.bincount(pid, minlength=spec.num_sub)
    return keys, rids, np.asarray(counts), group_counts


def _both_packed(wide, fanout_bits, key_bound, rid_bound, rng, key_space,
                 nb, cap, side):
    """(JAX spec, port spec, JAX words, port words, JAX unpacked, port
    unpacked, the blocks' keys, rids and counts)."""
    jspec = JT.make_wire_spec(cap, fanout_bits, wide=wide,
                              key_bound=key_bound, rid_bound=rid_bound)
    tspec = TT.make_wire_spec(cap, fanout_bits, wide=wide,
                              key_bound=key_bound, rid_bound=rid_bound)
    keys, rids, counts, gc = _contract_blocks(rng, jspec, key_space, nb)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    rid = rids.astype(np.uint32)
    jwords = np.asarray(JT.pack_blocks(jspec, JT.TupleBatch(
        key=jnp.asarray(lo), rid=jnp.asarray(rid),
        key_hi=jnp.asarray(hi) if wide else None), jnp.asarray(gc)))
    twords = TT.pack_blocks(tspec, TT.TupleBatch(
        key=_lane(lo), rid=_lane(rid), key_hi=_lane(hi) if wide else None),
        _lane(gc.reshape(-1)).view(nb, -1))
    junp = JT.unpack_blocks(jspec, jnp.asarray(jwords), side)
    tunp = TT.unpack_blocks(tspec, twords, side)
    return jspec, tspec, jwords, twords, junp, tunp, keys, rids, counts


@pytest.mark.parametrize("wide", [False, True], ids=["key32", "key64"])
@pytest.mark.parametrize("fanout_bits", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("bound", ["tight", "loose", "none"])
def test_pack_words_and_unpacked_lanes_equal_jax(wide, fanout_bits, bound):
    """The words equal JAX's bit for bit, header included; the unpacked
    lanes and counts equal JAX's and the packed tuples; pad slots unpack
    to the inner sentinels (garbage in them never leaks).  Fanout 0 takes
    the wide path's shift by 32 branch."""
    rng = np.random.default_rng(fanout_bits * 7 + (13 if wide else 0))
    nb, cap = 4, 64
    key_space = (1 << 44) if wide else (1 << 20)
    key_bound = {"tight": key_space, "loose": key_space << 7,
                 "none": None}[bound]
    rid_bound = {"tight": 1 << 20, "loose": 1 << 29, "none": None}[bound]
    (jspec, tspec, jwords, twords, (jb, jc), (tb, tc), keys, rids,
     counts) = _both_packed(wide, fanout_bits, key_bound, rid_bound, rng,
                            key_space, nb, cap, "inner")
    assert tuple(tspec) == tuple(jspec)
    assert tspec.bytes_per_tuple == jspec.bytes_per_tuple
    np.testing.assert_array_equal(_np(twords), jwords)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tc), counts)
    for name in ("key", "rid") + (("key_hi",) if wide else ()):
        np.testing.assert_array_equal(_np(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tb.key_hi is None if not wide else tb.key_hi is not None
    valid = (np.arange(nb * cap) % cap) < counts[np.arange(nb * cap) // cap]
    got_key = _np(tb.key).astype(np.uint64)
    if wide:
        got_key |= _np(tb.key_hi).astype(np.uint64) << np.uint64(32)
    np.testing.assert_array_equal(got_key[valid], keys[valid])
    np.testing.assert_array_equal(_np(tb.rid)[valid].astype(np.uint64),
                                  rids[valid])
    assert (_np(tb.key)[~valid] == TT.R_PAD_KEY).all()
    assert (_np(tb.rid)[~valid] == TT.PAD_RID).all()
    assert not TT.valid_mask(tb, "inner")[torch.from_numpy(~valid)].any()


def test_pack_outer_side_sentinels():
    """Slots past a block's count unpack to the outer sentinels."""
    rng = np.random.default_rng(3)
    *_, (jb, _), (tb, _), _, _, counts = _both_packed(
        False, 2, 1 << 10, 1 << 10, rng, 1 << 10, 3, 16, "outer")
    valid = (np.arange(3 * 16) % 16) < counts[np.arange(3 * 16) // 16]
    np.testing.assert_array_equal(_np(tb.key), np.asarray(jb.key))
    assert (_np(tb.key)[~valid] == TT.S_PAD_KEY).all()
    assert not TT.valid_mask(tb, "outer")[torch.from_numpy(~valid)].any()


@pytest.mark.parametrize("args", [
    (1024, 5, False, 1 << 20, 1 << 20), (64, 0, True, None, None),
    (8388608, 5, False, 1 << 25, 80_000_000), (5, 3, True, 1 << 64, 7),
    (1, 7, False, 1, 1)])
def test_wire_spec_geometry_equals_jax(args):
    cap, f, wide, kb, rb = args
    jspec = JT.make_wire_spec(cap, f, wide=wide, key_bound=kb, rid_bound=rb)
    tspec = TT.make_wire_spec(cap, f, wide=wide, key_bound=kb, rid_bound=rb)
    assert tuple(tspec) == tuple(jspec)
    assert tspec.bytes_per_block == jspec.bytes_per_block


def test_wire_spec_errors_equal_jax():
    spec = TT.make_wire_spec(1024, 5, key_bound=1 << 20, rid_bound=1 << 20)
    assert spec.tuple_bits == 35 and spec.header_words == 32
    for mod in (JT, TT):
        with pytest.raises(ValueError, match="capacity"):
            mod.make_wire_spec(0, 5)
        with pytest.raises(ValueError, match="fanout_bits"):
            mod.make_wire_spec(8, 32)
        with pytest.raises(ValueError, match="key_bound"):
            mod.make_wire_spec(8, 0, key_bound=0)
        with pytest.raises(ValueError, match="rid_bound"):
            mod.make_wire_spec(8, 0, rid_bound=0)
    with pytest.raises(ValueError, match="multiple"):
        TT.unpack_blocks(spec, torch.zeros(spec.block_words + 1,
                                           dtype=torch.int32), "inner")


@pytest.mark.parametrize("mode,block", [
    ("fused", 96), (1, 96), ("auto", 4095), ("auto", 4096), ("staged:5", 96),
    (7, 3), ("staged:3", 0), (4, 96)])
def test_parse_exchange_mode_equals_jax(mode, block):
    assert (twindow.parse_exchange_mode(mode, block)
            == jwindow.parse_exchange_mode(mode, block))


@pytest.mark.parametrize("mode", ["staged:x", "bogus", 0, "staged:0"])
def test_parse_exchange_mode_rejects_as_jax(mode):
    with pytest.raises(ValueError) as want:
        jwindow.parse_exchange_mode(mode, 96)
    with pytest.raises(ValueError) as got:
        twindow.parse_exchange_mode(mode, 96)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------ grouped scatter
def _grouped_inputs(seed, n=3000, wide=False):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 1 << 24, n, dtype=np.uint32)
    rid = np.arange(n, dtype=np.uint32)
    dest = rng.integers(0, N, n).astype(np.uint32)
    sub = (key & 31).astype(np.uint32)
    sub[rng.random(n) < 0.2] = 7            # a hot pid on every rank
    valid = rng.random(n) > 0.1
    hi = rng.integers(0, 1 << 30, n, dtype=np.uint32) if wide else None
    return key, rid, hi, dest, sub, valid


@pytest.mark.parametrize("cap,wide", [(1024, False), (700, False),
                                      (700, True)],
                         ids=["roomy", "clipped", "clipped-64"])
def test_grouped_scatter_equals_jax_pallas_interpret(cap, wide):
    """Blocks, unclipped counts, clipped group counts and overflow equal
    JAX's fused arm (``_scatter_blocks_fused``, the Pallas partition
    kernel in interpret mode, which keeps input order within a pid as K4
    does); the clip eats the highest pids of a block."""
    key, rid, hi, dest, sub, valid = _grouped_inputs(cap, wide=wide)
    jb, jc, jg, jo = jradix.scatter_to_blocks_grouped(
        JT.TupleBatch(jnp.asarray(key), jnp.asarray(rid),
                      None if hi is None else jnp.asarray(hi)),
        jnp.asarray(dest), jnp.asarray(sub), N, 32, cap, "outer",
        valid=jnp.asarray(valid), impl="pallas_interpret")
    tb, tc, tg, to = scatter_to_blocks_grouped(
        TT.TupleBatch(_lane(key), _lane(rid), None if hi is None
                      else _lane(hi)),
        _lane(dest), _lane(sub), N, 32, cap, "outer",
        valid=torch.from_numpy(valid))
    for name in ("key", "rid") + (("key_hi",) if wide else ()):
        np.testing.assert_array_equal(_np(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tg.reshape(-1)),
                                  np.asarray(jg).reshape(-1))
    assert int(to) == int(jo)
    if cap == 700:
        assert int(to) > 0
        assert (_np(tg.reshape(-1)).reshape(N, 32).sum(1) <= cap).all()


def test_grouped_scatter_equals_jax_loop_arm():
    """JAX's sort arm (``impl="loop"``) sorts unstably, so within one pid
    its order is its own: the counts, group counts and overflow equal the
    port's, and each block holds the same tuples a pid."""
    key, rid, hi, dest, sub, valid = _grouped_inputs(11)
    cap = 1024
    jb, jc, jg, jo = jradix.scatter_to_blocks_grouped(
        JT.TupleBatch(jnp.asarray(key), jnp.asarray(rid)),
        jnp.asarray(dest), jnp.asarray(sub), N, 32, cap, "inner",
        valid=jnp.asarray(valid), impl="loop")
    tb, tc, tg, to = scatter_to_blocks_grouped(
        TT.TupleBatch(_lane(key), _lane(rid)), _lane(dest), _lane(sub), N,
        32, cap, "inner", valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tg.reshape(-1)),
                                  np.asarray(jg).reshape(-1))
    assert int(to) == int(jo) == 0
    for lanes_t, lanes_j in ((tb.key, jb.key), (tb.rid, jb.rid)):
        a = _np(lanes_t).reshape(N, cap)
        b = np.asarray(lanes_j).reshape(N, cap)
        np.testing.assert_array_equal(np.sort(a, axis=1), np.sort(b, axis=1))
    # within a block the pids ascend
    rid_t = _np(tb.rid).reshape(N, cap)
    ok = rid_t != TT.PAD_RID
    pid_of = np.where(ok, sub[np.where(ok, rid_t, 0)], 99)
    assert (np.diff(pid_of, axis=1) >= 0).all()


def test_grouped_scatter_past_256_groups_equals_jax_loop_arm():
    """16 blocks x 32 pids = 512 groups, past K4's onesweep (its wide path
    on the card): counts, clipped group counts, overflow and each block's
    tuples equal JAX's sort arm, and the pids ascend within a block."""
    key, rid, _, dest, sub, valid = _grouped_inputs(5, n=4000)
    dest = dest * 4 + (key >> 5) % 4                 # 16 destinations
    cap = 150
    jb, jc, jg, jo = jradix.scatter_to_blocks_grouped(
        JT.TupleBatch(jnp.asarray(key), jnp.asarray(rid)),
        jnp.asarray(dest), jnp.asarray(sub), 16, 32, cap, "inner",
        valid=jnp.asarray(valid), impl="loop")
    tb, tc, tg, to = scatter_to_blocks_grouped(
        TT.TupleBatch(_lane(key), _lane(rid)), _lane(dest), _lane(sub), 16,
        32, cap, "inner", valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tg.reshape(-1)),
                                  np.asarray(jg).reshape(-1))
    assert int(to) == int(jo) > 0
    rid_t = _np(tb.rid).reshape(16, cap)
    ok = rid_t != TT.PAD_RID
    pid_of = np.where(ok, sub[np.where(ok, rid_t, 0)], 99)
    assert (np.diff(pid_of, axis=1) >= 0).all()
    # the clip eats a block's highest pids: JAX keeps the same pid counts,
    # and within the last kept pid its unstable sort may keep other tuples
    got = np.sort(_np(tb.key).reshape(16, cap), axis=1)
    want = np.sort(np.asarray(jb.key).reshape(16, cap), axis=1)
    full = _np(tc) <= cap
    np.testing.assert_array_equal(got[full], want[full])


# ------------------------------------------------------ staged exchange
BLOCK = 96          # not divisible by 5: uneven column groups
MODES = ["staged:2", "staged:5", "auto", "staged:96", 3]


def test_staged_all_to_all_equals_fused_and_jax(world):
    """``block_all_to_all`` in every mode, flat and over a 2 x 2 host grid:
    each receives exactly what JAX's fused flat route receives, and a
    staged mode issues one collective a column group."""
    x = (np.arange(N * N * BLOCK, dtype=np.uint32) * 2654435761
         ).astype(np.uint32)
    mesh = make_mesh(N)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda v: jwindow.block_all_to_all(v, N, BLOCK, "nodes"),
        mesh=mesh, in_specs=P("nodes"), out_specs=P("nodes")))(
        jnp.asarray(x))).reshape(N, -1)
    hmesh = make_hierarchical_mesh(2, N)
    want_h = np.asarray(jax.jit(jax.shard_map(
        lambda v: jwindow.block_all_to_all(v, N, BLOCK, ("dcn", "ici"),
                                           mode="staged:5"),
        mesh=hmesh, in_specs=P(("dcn", "ici")),
        out_specs=P(("dcn", "ici"))))(jnp.asarray(x))).reshape(N, -1)
    np.testing.assert_array_equal(want_h, want)
    got = world.run({"kind": "hierarchical", "num_nodes": N, "num_hosts": 2,
                     "blocks": x.reshape(N, -1).tolist(),
                     "modes": MODES})
    for rank, res in enumerate(got):
        for mode in MODES:
            for route in ("flat", "hier"):
                np.testing.assert_array_equal(
                    np.asarray(res[f"{route} {mode}"], np.uint32),
                    want[rank], err_msg=f"{route} {mode}")
            assert res[f"collectives {mode}"] == \
                twindow.parse_exchange_mode(mode, BLOCK)


# ---------------------------------------------------------- pack window
def _window_case(seed, wide=False):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 1 << 22, N * 1000, dtype=np.uint32)
    key[rng.random(key.size) < 0.3] = 3
    hi = (rng.integers(0, 1 << 12, key.size, dtype=np.uint32) if wide
          else None)
    rid = np.arange(key.size, dtype=np.uint32)
    assignment = (np.arange(32) * 3 % N).astype(np.uint32)
    return key, hi, rid, assignment


@pytest.mark.parametrize("codec,mode,wide", [
    ("pack", "fused", False), ("pack", "staged:3", False),
    ("pack", "fused", True), ("off", "staged:4", False)],
    ids=["pack", "pack-staged", "pack-64", "off-staged"])
def test_window_exchange_equals_jax_and_the_off_window(world, codec, mode,
                                                       wide):
    """``network_partition`` through a pack (or staged) window over four
    gloo ranks: the received lanes, valid slots, pids and counts equal
    JAX's window of the same codec and mode bit for bit (its grouped
    scatter on the Pallas interpret kernel), and the unpacked tuples equal
    the off window's; the pack window issues no count all_to_all, and
    ``receive_checksums`` of what arrived equal JAX's."""
    from tpu_radix_join.parallel.network_partitioning import (
        receive_checksums as j_receive_checksums)
    key, hi, rid, assignment = _window_case(17 if wide else 16, wide)
    cap, side = 1400, "outer"
    kb = (1 << 54) if wide else (1 << 22)
    kw = dict(codec=codec, mode=mode, fanout_bits=5, key_bound=kb,
              rid_bound=key.size)

    def body(k, r, h=None):
        win = jwindow.Window(N, cap, "nodes", side,
                             partition_impl="pallas_interpret", **kw)
        res = j_network_partition(JT.TupleBatch(k, r, h), 5,
                                  jnp.asarray(assignment), win)
        out = (res.batch.key, res.batch.rid, res.valid, res.pid,
               res.recv_counts,
               j_receive_checksums(res, 32, "nodes")[None])
        return out + ((res.batch.key_hi,) if h is not None else ())

    spec = P("nodes")
    args = [jnp.asarray(key), jnp.asarray(rid)] + (
        [jnp.asarray(hi)] if wide else [])
    outs = 6 + int(wide)
    want = [np.asarray(a) for a in jax.jit(jax.shard_map(
        body, mesh=make_mesh(N), in_specs=(spec,) * len(args),
        out_specs=(spec,) * 5 + (P(),) + (spec,) * int(wide)))(*args)]
    assert len(want) == outs
    task = {"kind": "exchange", "key": key.reshape(N, -1).tolist(),
            "rid": rid.reshape(N, -1).tolist(),
            "assignment": assignment.tolist(), "capacity": cap,
            "side": side, "fanout": 5, "window": kw, "checksums": True,
            "global_hist": np.bincount(key & 31, minlength=32).tolist()}
    if wide:
        task["key_hi"] = hi.reshape(N, -1).tolist()
    got = world.run(task)
    off = world.run(dict(task, window={}, checksums=False))
    names = ("key", "rid", "valid", "pid", "recv_counts")
    for rank, (res, raw) in enumerate(zip(got, off)):
        for name, arr in zip(names, want):
            np.testing.assert_array_equal(
                np.asarray(res[name]), arr.reshape(N, -1)[rank],
                err_msg=f"{name} of rank {rank}")
            # the same tuples a sender's block as the raw window's: the
            # packed blocks are grouped by pid, the raw ones in input order
            np.testing.assert_array_equal(
                np.sort(np.asarray(res[name]).reshape(N, -1), axis=1),
                np.sort(np.asarray(raw[name]).reshape(N, -1), axis=1))
        if wide:
            np.testing.assert_array_equal(np.asarray(res["key_hi"]),
                                          want[6].reshape(N, -1)[rank])
        np.testing.assert_array_equal(
            np.asarray(res["checksums"], np.uint32), want[5].reshape(-1))
        assert res["all_written"] and not res["bad"]
        # two lanes (three wide) and one count exchange raw; one packed
        lanes = 3 if wide else 2
        stages = twindow.parse_exchange_mode(mode, cap if codec == "off"
                                             else TT.make_wire_spec(
                                                 cap, 5, wide=wide,
                                                 key_bound=kb,
                                                 rid_bound=key.size
                                             ).block_words)
        want_a2a = stages if codec == "pack" else lanes * stages + 1
        assert res["counts"]["all_to_all"] == want_a2a


# ------------------------------------------------------------ whole joins
def _lanes(keys, hi=None):
    keys = np.asarray(keys, np.uint32)
    rid = np.arange(keys.size, dtype=np.uint32)
    key_hi = (None if hi is None
              else np.asarray(hi, np.uint32) + np.zeros(keys.size, np.uint32))
    return [keys, rid, key_hi]


def _rel(kind, seed, size, **kw):
    return dict(global_size=size, num_nodes=N, kind=kind, seed=seed, **kw)


def _hot_workload(size):
    half = size // 2
    return (_lanes(np.arange(size)),
            _lanes(np.concatenate([np.full(half, 3), np.arange(half)])))


UNIQUE = (_rel("unique", 1, 1 << 14), _rel("unique", 9, 1 << 14))
ZIPF = (_rel("unique", 1, 1 << 14),
        _rel("zipf", 3, 1 << 14, zipf_theta=0.75, key_domain=1 << 14))
#: id -> (JAX JoinConfig fields, relation specs or global lanes)
CASES = {
    "pack": (dict(exchange_codec="pack"), UNIQUE),
    "pack_zipf": (dict(exchange_codec="pack", max_retries=2), ZIPF),
    "auto": (dict(exchange_codec="auto"), UNIQUE),
    "auto_small_blocks": (dict(exchange_codec="auto"),
                          (_rel("unique", 1, 256), _rel("unique", 9, 256))),
    "staged_4": (dict(exchange_stages=4), UNIQUE),
    "staged_auto": (dict(exchange_stages=0, exchange_codec="pack"), UNIQUE),
    "pack_staged": (dict(exchange_codec="pack", exchange_stages=4), ZIPF),
    "pack_skew": (dict(exchange_codec="pack", skew_threshold=4.0,
                       max_retries=1), _hot_workload(1 << 14)),
    "pack_64": (dict(exchange_codec="pack", key_bits=64),
                (_rel("unique", 1, 1 << 13, key_bits=64),
                 _rel("unique", 9, 1 << 13, key_bits=64))),
    "pack_64_lanes": (dict(exchange_codec="pack", key_bits=64),
                      (_lanes(np.arange(1 << 13), hi=(1 << 20) + 7),
                       _lanes(np.arange(1 << 13)[::-1], hi=(1 << 20) + 7))),
    "pack_bucket": (dict(exchange_codec="pack", probe_algorithm="bucket"),
                    UNIQUE),
    "pack_static": (dict(exchange_codec="pack", window_sizing="static"),
                    (_lanes(np.arange(1 << 13)),
                     _lanes(np.arange(1 << 13) * 3))),
    "pack_chunked": (dict(exchange_codec="pack", chunk_size=1024), ZIPF),
    "hosts_staged": (dict(num_hosts=2, exchange_stages=4), UNIQUE),
    "hosts_pack_staged": (dict(num_hosts=2, exchange_stages=3,
                               exchange_codec="pack"), ZIPF),
}


def _jax_join(fields, data):
    jcfg = jx.JoinConfig(num_nodes=N, **fields)
    jm = JMeasurements()
    eng = jx.HashJoin(jcfg, measurements=jm)
    if isinstance(data[0], dict):
        want = eng.join(jx.Relation(**data[0]), jx.Relation(**data[1]))
    else:
        want = eng.join_arrays(*(JT.TupleBatch(*(
            None if lane is None else jnp.asarray(lane) for lane in lanes))
            for lanes in data))
    return jcfg, jm, want


def _task(jcfg, data, **kw):
    cfg = dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg)))
    task = {"kind": "join", "config": cfg, "measure": True, **kw}
    if isinstance(data[0], dict):
        task.update(inner=data[0], outer=data[1])
    else:
        task["lanes"] = {k: [None if lane is None else lane.tolist()
                             for lane in lanes]
                         for k, lanes in zip(("r", "s"), data)}
    return task


EXCHANGE_COUNTERS = ("WIREBYTES", "MWINBYTES", "PACKRATIO", "XSTAGES",
                     "WINCAPR", "WINCAPS", "MWINPUTCNT")


@pytest.mark.parametrize("case", list(CASES))
def test_join_over_four_ranks_equals_jax(world, case):
    """Counts, flags, ``meta["exchange_plan"]`` and the exchange counters
    equal JAX's ``HashJoin(num_nodes=4)`` under the same wire plan; every
    packed join also equals the raw one's counts."""
    fields, data = CASES[case]
    jcfg, jm, want = _jax_join(fields, data)
    assert want.ok, want.diagnostics
    got = world.run(_task(jcfg, data))
    for res in got:
        assert res["ok"] and res["matches"] == want.matches
        np.testing.assert_array_equal(
            np.asarray(res["partition_counts"], np.uint32),
            np.asarray(want.partition_counts))
        assert res["diagnostics"] == want.diagnostics
        assert res["exchange_plan"] == jm.meta["exchange_plan"]
        for name in EXCHANGE_COUNTERS:
            assert res["counters"].get(name) == jm.counters.get(name), name
    plan = got[0]["exchange_plan"]
    if fields.get("exchange_codec") == "pack":
        assert plan["codec_r"] == plan["codec_s"] == "pack"
        assert plan["pack_ratio_pct"] < 100
        # the header carries the counts: no count exchange on either side
        lanes = 3 if jcfg.key_bits == 64 else 2
        assert got[0]["collectives"]["all_to_all"] <= lanes * 2 * max(
            plan["stages_r"], plan["stages_s"]) * (got[0]["retries"] + 1)
    if case == "auto_small_blocks":
        assert plan["codec_r"] == "off"      # the header would not pay
    if case == "staged_4":
        assert plan["stages"] == 4 and got[0]["counters"]["XSTAGES"] == 4
        # each of two lanes a relation in 4 stages, one count exchange each
        assert got[0]["collectives"]["all_to_all"] == 2 * (2 * 4 + 1)
    if case == "pack":
        assert got[0]["collectives"]["all_to_all"] == 2


def test_materialize_over_four_ranks_under_pack_equals_jax(world):
    """``join_materialize`` under the packed exchange: the pairs equal
    JAX's as sorted lists (K2 and ``lax.sort`` order equal keys
    differently), and the exchange plan too."""
    data = ZIPF
    jcfg = jx.JoinConfig(num_nodes=N, exchange_codec="pack",
                         match_rate_cap=4, max_retries=3)
    jm = JMeasurements()
    want = jx.HashJoin(jcfg, measurements=jm).join_materialize(
        jx.Relation(**data[0]), jx.Relation(**data[1]))
    got = world.run(_task(jcfg, data, materialize=True))
    want_pairs = sorted(zip(np.asarray(want.r_rid).tolist(),
                            np.asarray(want.s_rid).tolist()))
    for res in got:
        assert res["ok"] == want.ok and res["matches"] == want.matches
        assert sorted(zip(res["r_rid"], res["s_rid"])) == want_pairs
        assert res["exchange_plan"] == jm.meta["exchange_plan"]
        assert res["exchange_plan"]["codec_s"] == "pack"


@pytest.mark.parametrize("mode", ["staged:3", "auto", 2])
def test_distribute_staged_equals_fused_and_jax(world, mode):
    """``distribute(mode=...)``: the staged pre-shuffle delivers what the
    fused one and JAX's do."""
    rng = np.random.default_rng(31)
    n = N * 240
    key = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    rid = np.arange(n, dtype=np.uint32)
    want = jax.jit(jax.shard_map(
        lambda k, r: tuple(j_distribute(JT.TupleBatch(k, r), N, "nodes",
                                        seed=5, mode=mode))[:2],
        mesh=make_mesh(N), in_specs=(P("nodes"),) * 2,
        out_specs=(P("nodes"),) * 2))(jnp.asarray(key), jnp.asarray(rid))
    lanes = [[key.reshape(N, -1)[i].tolist(), rid.reshape(N, -1)[i].tolist(),
              None] for i in range(N)]
    got = world.run({"kind": "distribute", "lanes": lanes, "seed": 5,
                     "mode": mode})
    fused = world.run({"kind": "distribute", "lanes": lanes, "seed": 5})
    for rank, (res, ref) in enumerate(zip(got, fused)):
        assert res["lanes"] == ref["lanes"]
        for i in range(2):
            np.testing.assert_array_equal(
                np.asarray(res["lanes"][i], np.uint32),
                np.asarray(want[i]).reshape(N, -1)[rank])


# ------------------------------------------------------------ config, CLI
@pytest.mark.parametrize("fields", [
    dict(exchange_codec="pack"), dict(exchange_codec="auto"),
    dict(exchange_stages=0), dict(exchange_stages=5),
    dict(exchange_codec="pack", exchange_stages=2, num_nodes=4)])
def test_config_carries_codec_and_stages(fields):
    jcfg = jx.JoinConfig(**fields)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert cfg == tx.JoinConfig(**fields)
    for name, value in fields.items():
        assert getattr(cfg, name) == value


def test_config_rejects_as_jax():
    for bad in (dict(exchange_codec="zip"), dict(exchange_stages=-1)):
        with pytest.raises(ValueError) as want:
            jx.JoinConfig(**bad)
        with pytest.raises(ValueError) as got:
            tx.JoinConfig(**bad)
        assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


def test_cli_flags_reach_the_config(monkeypatch):
    """``--exchange-codec`` and ``--exchange-stages`` (JAX ``main.py:
    66-80``) reach the port's JoinConfig; a one-rank join ships raw."""
    from tpu_radix_join_torch import main as tmain
    seen = []
    real = tx.HashJoin

    def spy(cfg, *a, **kw):
        seen.append(cfg)
        return real(cfg, *a, **kw)

    monkeypatch.setattr(tx, "HashJoin", spy)
    rc = tmain.main(["--device", "cpu", "--tuples-per-node", "2048",
                     "--exchange-codec", "pack", "--exchange-stages", "3",
                     "--probe", "bucket"])
    assert rc == 0
    assert seen[0].exchange_codec == "pack" and seen[0].exchange_stages == 3
    args = tmain.build_parser().parse_args(["--exchange-codec", "auto"])
    assert args.exchange_codec == "auto" and args.exchange_stages == 1
