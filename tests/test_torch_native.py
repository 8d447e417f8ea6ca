"""The port's native host library (``tpu_radix_join_torch/native``): the
pool allocator (``memory/pool.py``) and the multithreaded generators behind
``Relation.fill_np``, against the numpy plain versions and the JAX
package's ``Relation.fill_np`` (its native arm and its numpy arm), bit for
bit.  A failed build raises with the compiler's message."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.data import relation as jrel  # noqa: E402

from tpu_radix_join_torch.data import relation as trel  # noqa: E402
from tpu_radix_join_torch.memory import Pool  # noqa: E402
from tpu_radix_join_torch.native import build  # noqa: E402


def test_pool_bump_reset_and_overflow():
    pool = Pool(1 << 16)
    assert pool.native and not pool.pinned
    base, size = pool.region()
    assert base % 4096 == 0 and size == 1 << 16
    a = pool.get_array((100,), np.uint32)
    b = pool.get_array((100,), np.uint32)
    a[:] = 1
    b[:] = 2
    assert a.sum() == 100 and b.sum() == 200      # disjoint regions
    used = pool.used()
    assert used == 2 * 448 and used % 64 == 0      # 64-byte bumps
    big = pool.get_array((1 << 15,), np.uint32)   # past the region
    big[:] = 3
    assert big.sum() == 3 * (1 << 15) and pool.used() == used
    pool.reset()
    assert pool.used() == 0
    again = pool.get_array((100,), np.uint32)
    assert again.ctypes.data == a.ctypes.data     # rewound to the start
    pool.close()
    pool.close()                                   # idempotent
    with pytest.raises(ValueError, match="closed"):
        pool.used()


def test_pool_view_survives_gc():
    arr = Pool(1 << 16).get_array((1000,), np.uint32)
    gc.collect()
    arr[:] = 0xABCD
    assert int(arr.sum()) == 1000 * 0xABCD


def _numpy_arm(rel, start, count):
    """The plain versions: the numpy generators the port keeps."""
    idx = np.arange(start, start + count, dtype=np.uint64)
    if rel.kind == "unique":
        bits = max(2, (rel.global_size - 1).bit_length())
        k = trel.feistel_permutation_np(idx, bits, rel.seed)
        while (k >= rel.global_size).any():
            out = k >= rel.global_size
            k[out] = trel.feistel_permutation_np(k[out], bits, rel.seed)
        return k.astype(np.uint32)
    if rel.kind == "modulo":
        return (idx % rel.modulo).astype(np.uint32)
    head, tail = trel.zipf_tables(rel.zipf_theta, rel.key_domain)
    return trel.zipf_keys_np(start, count, head, tail, rel.key_domain,
                             rel.seed)


CASES = {
    "unique_pow2": dict(global_size=1 << 14, num_nodes=4, kind="unique"),
    "unique_walk": dict(global_size=3 * 5000, num_nodes=3, kind="unique"),
    "modulo": dict(global_size=1 << 12, num_nodes=2, kind="modulo",
                   modulo=17),
    "zipf_head": dict(global_size=1 << 13, num_nodes=2, kind="zipf",
                      zipf_theta=0.75, key_domain=1024),
    "zipf_large_domain": dict(global_size=1 << 18, num_nodes=1, kind="zipf",
                              zipf_theta=0.75, key_domain=1 << 20),
    # past 2**16 keys a fill runs on several threads
    "unique_threaded": dict(global_size=(1 << 18) + 3000, num_nodes=1,
                            kind="unique"),
    "zipf_64": dict(global_size=1 << 12, num_nodes=2, kind="zipf",
                    zipf_theta=0.5, key_bits=64),
}


@pytest.mark.parametrize("threads", [1, 0, 7])
@pytest.mark.parametrize("case", list(CASES))
def test_native_fills_equal_numpy_and_jax(case, threads, monkeypatch):
    spec = dict(seed=9, **CASES[case])
    got_rel, jax_rel = trel.Relation(**spec), jrel.Relation(**spec)
    for node in range(spec["num_nodes"]):
        got = got_rel.shard_np(node, num_threads=threads)
        want = jax_rel.shard_np(node, num_threads=threads)   # JAX native
        lo = node * got_rel.local_size
        np.testing.assert_array_equal(
            got[0], _numpy_arm(got_rel, lo, got_rel.local_size))
        np.testing.assert_array_equal(
            got[-1], np.arange(lo, lo + got_rel.local_size, dtype=np.uint32))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.uint32
            np.testing.assert_array_equal(g, w)
    monkeypatch.setattr(jrel, "_load_native", lambda: None)    # JAX numpy
    for g, w in zip(got_rel.shard_np(0, threads), jax_rel.shard_np(0)):
        np.testing.assert_array_equal(g, w)
    if spec.get("key_domain", 0) > 65536:
        keys = got_rel.shard_np(0)[0]
        assert 65536 < keys.max() < spec["key_domain"]   # the tail is drawn


def test_fill_np_into_pool_views():
    rel = trel.Relation(1 << 14, 1, "unique", seed=5)
    pool = Pool(2 * 1000 * 4 + 128)
    key, rid = pool.get_array((1000,)), pool.get_array((1000,))
    out = rel.fill_np(7000, 1000, num_threads=3, out_key=key, out_rid=rid)
    assert out[0] is key and out[1] is rid
    want = jrel.Relation(1 << 14, 1, "unique", seed=5).fill_np(7000, 1000)
    np.testing.assert_array_equal(key, want[0])
    np.testing.assert_array_equal(rid, want[1])
    pool.close()


def test_build_is_cached_and_a_failed_build_raises(tmp_path):
    lib = build.load()
    assert build.load() is lib
    path = build.library_path()
    assert path.exists() and path.parent == build.BUILD_DIR
    assert path.name.startswith("libtrj_native_")
    bad = tmp_path / "bad.cc"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    out = tmp_path / "libbad.so"
    with pytest.raises(RuntimeError, match="undeclared_name") as e:
        build.compile_library([bad], out)
    assert "native build failed" in str(e.value)
    assert not out.exists() and list(tmp_path.iterdir()) == [bad]
