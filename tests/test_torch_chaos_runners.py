"""The join-path chaos runners of the port (robustness/chaos.py) against
the JAX package.

  * the three schedule generators (:func:`generate_schedule`,
    :func:`generate_recovery_schedule`, :func:`generate_session_schedule`)
    equal JAX's for seeds 0-63;
  * on one 4-rank gloo world (tests/torch_dist_worker.py), the fixed-seed
    recovery soak and the join soak give every rank JAX's outcomes and
    summary (``num_nodes=4`` in one process there), with no VIOLATION;
  * the session soak at one rank equals JAX's at ``num_nodes=1``, the
    one violation both packages share included;
  * ``shrink`` and ``write_repro``, and a violation's forensics bundle,
    which carries the schedule, the recovery record and the hedge-claim
    timeline that ``merge_bundles`` renders.

Tolerance 0 throughout."""

import json

import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.robustness import chaos as jchaos  # noqa: E402

from tpu_radix_join_torch.observability.postmortem import (  # noqa: E402
    load_bundle, merge_bundles)
from tpu_radix_join_torch.robustness import chaos  # noqa: E402
from torch_dist_worker import WorkerPool  # noqa: E402

N = 4


@pytest.mark.parametrize("gen", ["generate_schedule",
                                 "generate_recovery_schedule",
                                 "generate_session_schedule"])
def test_schedules_equal_jax_for_seeds_0_to_63(gen):
    for seed in range(64):
        got = getattr(chaos, gen)(seed)
        want = getattr(jchaos, gen)(seed)
        assert got.to_json() == want.to_json(), seed
        assert getattr(chaos, gen)(seed) == got
    assert chaos.RECOVERY_SITES == jchaos.RECOVERY_SITES
    assert chaos.SESSION_SITES == jchaos.SESSION_SITES
    assert chaos.CHAOS_SITES == jchaos.CHAOS_SITES


def test_shrink_and_write_repro(tmp_path):
    sched = chaos.Schedule(seed=3, arms=(("a", (("at", 1),)),
                                         ("b", (("at", 2),)),
                                         ("c", (("at", 1),))))
    got = chaos.shrink(sched, lambda s: any(a == "b" for a, _ in s.arms))
    assert got.arms == (("b", (("at", 2),)),)
    with pytest.raises(ValueError):
        chaos.shrink(sched, lambda s: False)
    out = chaos.RunOutcome(got, chaos.VIOLATION, None, 7, "wrong")
    line = chaos.write_repro(out, tmp_path / "repro.json")
    jline = jchaos.write_repro(jchaos.RunOutcome(
        jchaos.Schedule.from_json(got.to_json()), jchaos.VIOLATION, None, 7,
        "wrong"), tmp_path / "jrepro.json")
    assert line == jline
    assert json.loads((tmp_path / "repro.json").read_text()) == \
        json.loads(line)


def test_violation_bundle_renders_the_recovery_timeline(tmp_path):
    """A recovery run's registry records the admission, the regrowth, the
    hedge's claims and the recovery; a violation's bundle carries them with
    the schedule and ``merge_bundles`` renders them as the recovery
    timeline."""
    runner = chaos.RecoveryChaosRunner(num_nodes=1, size=1 << 10,
                                       device="cpu",
                                       bundle_dir=str(tmp_path / "b"))
    try:
        sched = chaos.Schedule(seed=1, arms=(
            ("membership.rank_join", (("at", 1),)),))
        # a claim before the run, as a hedge's: the fence's forensic trail
        runner.oracle += 1                  # every PASS is now a violation
        bind = runner._bind

        def bind_and_claim(m):
            bind(m)
            runner.engine.partition_manifest.claim(0, owner=1, epoch=1)
        runner._bind = bind_and_claim
        out = runner.run(sched)
    finally:
        runner.close()
    assert out.status == chaos.VIOLATION and out.bundle
    bundle = load_bundle(out.bundle)
    assert bundle["chaos"] == sched.to_json()
    events = {e["event"] for e in bundle["events_tail"]}
    assert {"rank_join", "regrow", "hedge_claim", "recovery"} <= events
    merged = merge_bundles([out.bundle])
    assert {e["event"] for e in merged["recovery_timeline"]} >= {
        "rank_join", "regrow", "hedge_claim", "recovery"}


def test_session_soak_equals_jax():
    runs, base = 3, 40
    got_outs, got = chaos.soak_session(
        runs, base_seed=base,
        runner=chaos.SessionChaosRunner(num_nodes=1, size=1 << 10,
                                        queries=4, device="cpu"))
    want_outs, want = jchaos.soak_session(
        runs, base_seed=base,
        runner=jchaos.SessionChaosRunner(num_nodes=1, size=1 << 10,
                                         queries=4))
    assert got == want
    assert [(o.status, o.failure_class, o.matches, o.detail)
            for o in got_outs] == \
        [(o.status, o.failure_class, o.matches, o.detail)
         for o in want_outs]
    # both packages: the corrupt-lane arm of seed 40 flips a key on the
    # one-rank sort probe, which exchanges and verifies nothing, so the
    # flip is a silent wrong count (ROADMAP C: a one-rank session's
    # corrupt lane); every other stream holds the invariant
    bad = [o for o in got_outs if o.status == chaos.VIOLATION]
    assert [o.schedule.seed for o in bad] == [40]
    assert "exchange.corrupt_lane" in [a for a, _ in bad[0].schedule.arms]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pool = WorkerPool(N, tmp_path_factory.mktemp("gloo_chaos"),
                      deadline_s=300.0)
    yield pool
    pool.close()


def _outcomes(outs):
    return [(o["status"], o["failure_class"], o["matches"],
             o["schedule"]) for o in outs]


def test_recovery_soak_equals_jax(world):
    """Fixed seeds over rank death, rank join and a straggler: every rank's
    outcomes and summary equal JAX's, with no VIOLATION, no watchdog trip,
    and the three membership sites all exercised."""
    runs, base = 6, 230
    outs = world.run({"kind": "soak", "which": "recovery", "runs": runs,
                      "base_seed": base, "runner": {"num_nodes": N,
                                                    "size": 1 << 11}})
    jouts, want = jchaos.soak_recovery(
        runs, base_seed=base,
        runner=jchaos.RecoveryChaosRunner(num_nodes=N, size=1 << 11))
    assert want["violations"] == 0
    wanted = _outcomes([o.to_json() for o in jouts])
    for got in outs:
        assert got["summary"] == want
        assert _outcomes(got["outcomes"]) == wanted
    s = outs[0]["summary"]
    assert s["wdogtrip"] == 0 and s["ranklost"] >= 1 and s["rankjoin"] >= 1
    assert s["hedged"] >= 1 and s["hedgewin"] >= 1
    assert s["manifest_exact"] >= s["pass"]


def test_join_soak_equals_jax(world):
    runs, base = 6, 7
    outs = world.run({"kind": "soak", "which": "join", "runs": runs,
                      "base_seed": base,
                      "runner": {"num_nodes": N, "size": 1 << 11}})
    jouts, want = jchaos.soak(runs, base_seed=base,
                              runner=jchaos.ChaosRunner(num_nodes=N,
                                                        size=1 << 11))
    assert want["violations"] == 0
    wanted = _outcomes([o.to_json() for o in jouts])
    for got in outs:
        assert got["summary"] == want
        assert _outcomes(got["outcomes"]) == wanted
