"""The partition manifest of the port (``robustness/checkpoint.
PartitionManifest``) against the JAX package's: the same sequence of
``mark_done``, ``mark_many``, ``claim`` and torn-line writes gives equal
``completed()``, ``claims()`` and ``audit()`` through either class, on
either package's file; the fingerprint guard; and the joins that record
into one: a one-rank engine join (its lines sum to its total), a session's
queries, and ``main --elastic on --checkpoint-dir``, whose manifest file
equals the JAX command line's."""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.main import main as jax_main  # noqa: E402
from tpu_radix_join.robustness import checkpoint as jckpt  # noqa: E402

from tpu_radix_join_torch import HashJoin, JoinConfig, Relation  # noqa: E402
from tpu_radix_join_torch.core.config import ServiceConfig  # noqa: E402
from tpu_radix_join_torch.main import main as tx_main  # noqa: E402
from tpu_radix_join_torch.performance.measurements import (  # noqa: E402
    Measurements)
from tpu_radix_join_torch.robustness import checkpoint as tckpt  # noqa: E402
from tpu_radix_join_torch.robustness.membership import (  # noqa: E402
    LeaseBoard, MembershipView)
from tpu_radix_join_torch.service import (JoinSession,  # noqa: E402
                                          QueryRequest)

FP = {"join": "unique:4096", "partitions": 32}


def _script(mf, path):
    """Appends, claims, a bulk write, a newer epoch and a torn last line;
    the claim verdicts in order."""
    verdicts = []
    mf.mark_done(3, 100, owner=1)
    mf.mark_done(3, 999, owner=2)               # same epoch: fenced
    verdicts.append(mf.claim(5, owner=0))
    verdicts.append(mf.claim(5, owner=1))       # a rival: lost
    verdicts.append(mf.claim(5, owner=0))       # the holder again
    mf.mark_many({0: 7, 1: 8, 2: 2**33 + 5}, owner_of=lambda p: p % 2)
    verdicts.append(mf.claim(1, owner=3))       # done at this epoch
    mf.mark_done(3, 55, owner=2, epoch=1)       # a newer epoch supersedes
    verdicts.append(mf.claim(5, owner=2, epoch=1))
    mf.mark_done(6, 11, owner=0)
    with open(path, "a") as f:
        f.write('{"partition": 9, "count": 1, "owner": 0, "epoch": 0}\n')
        f.write('{"partition": 4, "count": ')   # torn: killed mid-line
    return verdicts


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_manifest_sequence_equals_jax(tmp_path, reader):
    tpath, jpath = tmp_path / "t.manifest", tmp_path / "j.manifest"
    tm = tckpt.PartitionManifest(str(tpath), FP, measurements=Measurements())
    jm = jckpt.PartitionManifest(str(jpath), FP)
    assert _script(tm, tpath) == _script(jm, jpath) == [
        True, False, True, False, True]
    assert tpath.read_text() == jpath.read_text()
    # either package's reader over the port's file
    cls = tckpt.PartitionManifest if reader == "port" else \
        jckpt.PartitionManifest
    got, want = cls(str(tpath), FP), jckpt.PartitionManifest(str(jpath), FP)
    assert got.completed() == want.completed()
    assert got.claims() == want.claims()
    assert got.audit() == want.audit()
    done = got.completed()
    assert done[3] == {"count": 55, "owner": 2, "epoch": 1}
    assert 4 not in done and done[6]["count"] == 11
    assert got.audit() == {"total": 7 + 8 + 2**33 + 5 + 55 + 1 + 11,
                           "partitions": 6, "fenced_duplicates": {}}
    assert got.claims() == {5: {"owner": 2, "epoch": 1}}


def test_fingerprint_guard_and_io_failures(tmp_path):
    path = str(tmp_path / "m.manifest")
    tckpt.PartitionManifest(path, FP).mark_done(0, 1, owner=0)
    with pytest.raises(tckpt.CheckpointMismatch, match="different join"):
        tckpt.PartitionManifest(path, {"join": "other"})
    with pytest.raises(jckpt.CheckpointMismatch):
        jckpt.PartitionManifest(path, {"join": "other"})
    assert tckpt.CheckpointMismatch.failure_class == "checkpoint_mismatch"
    (tmp_path / "corrupt.manifest").write_text("not json\n")
    m = Measurements()
    mf = tckpt.PartitionManifest(str(tmp_path / "corrupt.manifest"), FP,
                                 measurements=m)
    assert mf.completed() == {}
    gone = tckpt.PartitionManifest(str(tmp_path / "no" / "dir.manifest"), FP,
                                   measurements=m)
    assert gone.mark_done(0, 1, owner=0) is False     # an event, no raise
    assert gone.completed() == {}
    events = [e for e, _ in m.events]
    assert events == ["manifest_corrupt", "manifest_init_failed",
                      "manifest_append_failed"]


def test_engine_join_records_its_partitions(tmp_path):
    path = str(tmp_path / "j.manifest")
    mf = tckpt.PartitionManifest(path, FP)
    r = Relation(4096, 1, "unique", seed=1)
    s = Relation(4096, 1, "zipf", seed=2, zipf_theta=0.75, key_domain=4096)
    engine = HashJoin(JoinConfig(), device="cpu")
    assert engine.partition_manifest is None and engine._my_partitions_done() == -1
    plain = engine.join(r, s)
    engine.partition_manifest = mf
    res = engine.join(r, s)
    assert res.ok and res.matches == plain.matches == 4096
    done = mf.completed()
    counts = np.asarray(res.partition_counts, dtype=np.uint64)
    assert sorted(done) == list(range(32))
    assert [done[p]["count"] for p in range(32)] == [int(c) for c in counts]
    assert {d["owner"] for d in done.values()} == {0}
    assert mf.audit()["total"] == res.matches
    assert engine._my_partitions_done() == 32
    # with a membership view, every lease beat carries that progress
    board = LeaseBoard(str(tmp_path / "leases"), rank=0, num_ranks=1)
    engine.membership = MembershipView(board)
    engine.join(r, s)
    assert board.progress_of == engine._my_partitions_done
    board.heartbeat(0)
    assert board.read(0).partitions_done == 32
    # the bucket path's counts are per partition too; a failed join (the
    # Zipf head overflows a bucket, no retries) records nothing
    bucket = HashJoin(JoinConfig(probe_algorithm="bucket"), device="cpu")
    bucket.partition_manifest = tckpt.PartitionManifest(
        str(tmp_path / "b.manifest"), FP)
    assert not bucket.join(r, s).ok
    assert bucket.partition_manifest.completed() == {}
    res = bucket.join(r, Relation(4096, 1, "unique", seed=3))
    assert res.ok and bucket.partition_manifest.audit() == {
        "total": 4096, "partitions": 32, "fenced_duplicates": {}}


def test_session_threads_the_manifest(tmp_path):
    mf = tckpt.PartitionManifest(str(tmp_path / "s.manifest"), FP)
    sess = JoinSession(JoinConfig(), ServiceConfig(), device="cpu",
                       partition_manifest=mf)
    try:
        assert sess.engine.partition_manifest is mf
        sess.submit(QueryRequest(query_id="q0", tuples_per_node=2048))
        out = sess.run_next()
        assert out.status == "ok" and out.matches == 2048
        assert mf.audit() == {"total": 2048, "partitions": 32,
                              "fenced_duplicates": {}}
        assert sess._degraded_engine().partition_manifest is mf
    finally:
        sess.close()


def test_main_manifest_file_equals_jax(tmp_path):
    argv = ["--nodes", "1", "--tuples-per-node", "4096", "--outer-kind",
            "zipf", "--elastic", "on"]
    files = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", tx_main, ["--device", "cpu"])):
        d = tmp_path / name
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = main([*argv, *extra, "--checkpoint-dir", str(d / "ck"),
                       "--lease-dir", str(d / "leases")])
        assert rc == 0
        files[name] = (d / "ck" / "partitions.manifest").read_text()
        total = [x for x in out.getvalue().splitlines()
                 if x.startswith("[RESULTS] Tuples:")]
        assert total == ["[RESULTS] Tuples: 4096"]
    assert files["port"] == files["jax"]
    lines = files["port"].splitlines()
    assert json.loads(lines[0]) == {"fingerprint": "elastic:zipf:4096:1234:32",
                                    "schema": 1}
    assert len(lines) == 33
    assert sum(json.loads(x)["count"] for x in lines[1:]) == 4096
    # a second run of the same join leaves completed() as it was; another
    # fingerprint raises
    path = str(tmp_path / "port" / "ck" / "partitions.manifest")
    before = tckpt.PartitionManifest(
        path, "elastic:zipf:4096:1234:32").completed()
    port_argv = [*argv, "--device", "cpu", "--checkpoint-dir",
                 str(tmp_path / "port" / "ck"), "--lease-dir",
                 str(tmp_path / "port" / "leases")]
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert tx_main(port_argv) == 0
        assert tckpt.PartitionManifest(
            path, "elastic:zipf:4096:1234:32").completed() == before
        with pytest.raises(tckpt.CheckpointMismatch):
            tx_main([*port_argv, "--seed", "9"])
