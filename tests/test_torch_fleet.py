"""The crash-only fleet of the port, in process (no worker is spawned): the
consistent-hash ring, the worker-kill schedules, the supervisor's
readiness / statusz / summary shapes, the fleet tags and fault site, the
regression gate and the command line's checks, each exactly equal to the
JAX package's (tpu_radix_join/service/fleet.py, robustness/chaos.py,
observability/regress.py, main.py)."""

import json
import os
import random
import time

import pytest

pytest.importorskip("torch")

import tpu_radix_join.observability.regress as jregress  # noqa: E402
import tpu_radix_join.performance.measurements as jmeas  # noqa: E402
import tpu_radix_join.robustness.chaos as jchaos  # noqa: E402
import tpu_radix_join.robustness.faults as jfaults  # noqa: E402
import tpu_radix_join.service.fleet as jfleet  # noqa: E402
from tpu_radix_join.main import main as jmain  # noqa: E402
from tpu_radix_join.service.journal import (  # noqa: E402
    QueryJournal as JQueryJournal)

import tpu_radix_join_torch.observability.regress as tregress  # noqa: E402
import tpu_radix_join_torch.performance.measurements as tmeas  # noqa: E402
import tpu_radix_join_torch.robustness.chaos as tchaos  # noqa: E402
import tpu_radix_join_torch.robustness.faults as tfaults  # noqa: E402
import tpu_radix_join_torch.service as tservice  # noqa: E402
import tpu_radix_join_torch.service.fleet as tfleet  # noqa: E402
from tpu_radix_join_torch.main import (  # noqa: E402
    _fleet_worker_args, build_parser, main as tmain)

FLEET_TAGS = ("FAILOVER", "REPLAYN", "WINCARN", "WRESTART", "JDEPTH",
              "DOUBLEEXEC")


# --------------------------------------------------------------------- ring

def _slot_sets(rng, n):
    out = [[0], [0, 1], [0, 1, 2, 3], [], [3, 1, 1]]
    while len(out) < n:
        k = rng.randint(1, 8)
        out.append(rng.sample(range(12), k))
    return out


@pytest.mark.parametrize("vnodes", [32, 1, 7])
def test_ring_points_equal_jax(vnodes):
    for slots in _slot_sets(random.Random(vnodes), 24):
        uniq = sorted(set(slots))
        assert tfleet.ring_points(uniq, vnodes) == jfleet.ring_points(
            uniq, vnodes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_tenant_equal_jax(seed):
    """A few hundred seeded tenants over seeded slot sets, each set again
    with one slot dead: the same owner, bit for bit."""
    rng = random.Random(seed)
    tenants = [f"t{rng.randrange(1 << 30)}" for _ in range(300)]
    tenants += ["default", "", "sig:(1024, 'unique', None, 0.75, 1)"]
    for slots in _slot_sets(rng, 12):
        sets = [slots]
        if len(set(slots)) > 1:
            dead = rng.choice(sorted(set(slots)))
            sets.append([s for s in slots if s != dead])
        for live in sets:
            got = [tfleet.route_tenant(t, live) for t in tenants]
            assert got == [jfleet.route_tenant(t, live) for t in tenants]
            if live:
                assert set(got) <= set(live)
            else:
                assert set(got) == {None}


def test_ring_removal_moves_only_the_dead_slots_tenants():
    slots = [0, 1, 2, 3]
    before = {f"t{i}": tfleet.route_tenant(f"t{i}", slots)
              for i in range(256)}
    after = {t: tfleet.route_tenant(t, [0, 2, 3]) for t in before}
    assert len(set(before.values())) == 4
    for t, owner in before.items():
        if owner == 1:
            assert after[t] in (0, 2, 3)
        else:
            assert after[t] == owner


def test_service_exports_the_fleet():
    assert tservice.FleetSupervisor is tfleet.FleetSupervisor
    assert tservice.ring_points is tfleet.ring_points
    assert tservice.route_tenant is tfleet.route_tenant
    assert {"FleetSupervisor", "ring_points", "route_tenant"} <= set(
        tservice.__all__)


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("queries", [1, 2, 3, 4, 9])
def test_generate_fleet_schedule_equal_jax(queries):
    for seed in range(64):
        got = tchaos.generate_fleet_schedule(seed, queries)
        want = jchaos.generate_fleet_schedule(seed, queries)
        assert got.to_json() == want.to_json()
        assert tchaos.Schedule.from_json(want.to_json()) == got
    assert tchaos.FLEET_SITES == jchaos.FLEET_SITES
    assert (tchaos.PASS, tchaos.CLASSIFIED, tchaos.VIOLATION) == (
        jchaos.PASS, jchaos.CLASSIFIED, jchaos.VIOLATION)


def test_schedule_and_outcome_json_equal_jax():
    arms = (("fleet.worker_kill", (("at", 2),)),
            ("engine.shuffle_overflow", (("at", 1), ("times", 1))))
    ts, js = tchaos.Schedule(5, arms), jchaos.Schedule(5, arms)
    assert ts.to_json() == js.to_json()
    assert ts.without(0).to_json() == js.without(0).to_json()
    assert ts.arm_dicts() == js.arm_dicts()
    for kw in ({}, {"bundle": "/b/x.json"}):
        t = tchaos.RunOutcome(ts, tchaos.VIOLATION, None, 3, "d", **kw)
        j = jchaos.RunOutcome(js, jchaos.VIOLATION, None, 3, "d", **kw)
        assert t.to_json() == j.to_json()


def test_soak_fleet_needs_a_runner_or_a_supervisor():
    with pytest.raises(ValueError, match="runner or a supervisor"):
        tchaos.soak_fleet(1)


# ------------------------------------------------- supervisor, never started

class _Alive:
    """A stand-in for a live worker process (no process is spawned)."""

    def __init__(self, pid):
        self.pid = pid

    def poll(self):
        return None


def _pair(tmp_path, workers, **kw):
    return (tfleet.FleetSupervisor(workers, ["--nodes", "1"],
                                   str(tmp_path / "t"), **kw),
            jfleet.FleetSupervisor(workers, ["--nodes", "1"],
                                   str(tmp_path / "j"), **kw))


def _section(sup):
    out = json.loads(json.dumps(sup.statusz_section()))
    out["journal"]["path"] = os.path.basename(out["journal"]["path"])
    return out


@pytest.mark.parametrize("kw", [{}, {"result_cache_max": 4,
                                     "result_cache_ttl_s": 30.0},
                                {"batch_window_ms": 5.0}],
                         ids=["plain", "cache", "batch"])
def test_never_started_supervisor_equals_jax(tmp_path, kw):
    t, j = _pair(tmp_path, 2, **kw)
    assert t.readiness() == j.readiness() == {
        "ok": False, "reason": "no_healthy_worker"}
    assert _section(t) == _section(j)
    assert t.summary() == j.summary()
    assert t.lapse_window_s == j.lapse_window_s == 10.0
    for sup in (t, j):
        sup.draining = True
    assert t.readiness() == j.readiness() == {"ok": False,
                                              "reason": "draining"}
    assert _section(t) == _section(j)
    assert _section(t)["draining"] is True
    with pytest.raises(ValueError):
        tfleet.FleetSupervisor(0, [], str(tmp_path / "z"))


def test_worker_states_and_journal_depth_equal_jax(tmp_path):
    """Stand-in live workers with fresh, stale and missing leases, on one
    fake clock, over journals with unacknowledged intents: the same
    states, routing, readiness, statusz and summary as JAX's."""
    now = [1000.0]
    t, j = _pair(tmp_path, 4, clock=lambda: now[0], lease_s=1.0,
                 boot_grace_s=5.0)
    for sup in (t, j):
        for slot, w in sup.workers.items():
            w.incarnations = 1
            w.spawned_mono = 999.0
            if slot != 3:
                w.proc = _Alive(100 + slot)
            os.makedirs(w.lease_dir(), exist_ok=True)
        for slot, age in ((0, 0.5), (1, 30.0)):
            with open(os.path.join(sup.workers[slot].lease_dir(),
                                   "lease_r0.json"), "w") as f:
                json.dump({"t_epoch_s": time.time() - age}, f)
        sup.workers[3].not_before = 1002.0
        sup.journal.append_intent({"query_id": "a", "seed": 1}, worker=0)
        sup.journal.append_intent({"query_id": "b", "seed": 2}, worker=1)
        sup.journal.append_outcome(
            sup.journal.unacknowledged()[0]["fp"], {"query_id": "a"})
        sup._gauge_depth()
    for sup in (t, j):
        got = {f"w{s}": sup.worker_state(w) for s, w in sup.workers.items()}
        assert got == {"w0": "serving", "w1": "stale", "w2": "booting",
                       "w3": "backoff"}
    assert t.routable_slots() == j.routable_slots() == [0, 2]
    assert t.readiness() == j.readiness() == {"ok": True}
    ts, js = _section(t), _section(j)
    for sec in (ts, js):
        for w in sec["workers"].values():
            w["lease_age_s"] = w["lease_age_s"] is not None
    assert ts == js
    assert ts["journal"]["depth"] == 1
    assert t.summary() == j.summary()
    assert [t.pick_worker(f"x{i}").slot for i in range(32)] == [
        j.pick_worker(f"x{i}").slot for i in range(32)]
    now[0] = 1010.0
    assert t.worker_state(t.workers[2]) == "stale"
    assert t.worker_state(t.workers[3]) == "dead"
    assert t.routable_slots() == j.routable_slots() == [0]


def test_batch_signature_and_worker_command_equal_jax(tmp_path):
    t, j = _pair(tmp_path, 1, batch_window_ms=5.0)
    for req in ({}, {"tuples_per_node": 4096, "outer_kind": "zipf"},
                {"modulo": 7, "repeats": 2, "tenant": "x"}):
        assert t._batch_signature(req) == j._batch_signature(req)
    for sup in (t, j):
        sup._python = "python3"
    tcmd, jcmd = t._worker_cmd(t.workers[0]), j._worker_cmd(j.workers[0])
    assert tcmd[:3] == ["python3", "-m", "tpu_radix_join_torch.main"]
    assert jcmd[:3] == ["python3", "-m", "tpu_radix_join.main"]
    assert ([a.replace(str(tmp_path / "t"), "D") for a in tcmd[3:]]
            == [a.replace(str(tmp_path / "j"), "D") for a in jcmd[3:]])
    off, _ = _pair(tmp_path / "off", 1)
    assert off._batch_signature({"tuples_per_node": 8}) is None


def test_supervisor_reads_a_journal_jax_wrote(tmp_path):
    """Same schema: the port's supervisor sees a JAX journal's
    unacknowledged intents, depth and audit as JAX's does."""
    d = str(tmp_path / "fleet")
    jj = JQueryJournal(d)
    for i in range(3):
        jj.append_intent({"query_id": f"q{i}", "seed": i}, worker=0,
                         incarnation="w0i1")
    jj.append_outcome(jj.unacknowledged()[1]["fp"], {"query_id": "q1"})
    t = tfleet.FleetSupervisor(1, [], d)
    j = jfleet.FleetSupervisor(1, [], d)
    assert t.journal.unacknowledged() == j.journal.unacknowledged()
    assert [r["query_id"] for r in t.journal.unacknowledged()] == ["q0", "q2"]
    assert t.journal.audit().to_json() == j.journal.audit().to_json()
    assert t.journal.audit().unacked == 2


# ------------------------------------------------------- tags and fault site

@pytest.mark.parametrize("tag", FLEET_TAGS)
def test_fleet_tags_equal_jax(tag):
    assert getattr(tmeas, tag) == getattr(jmeas, tag) == tag


def test_fleet_worker_kill_site_equal_jax():
    assert tfaults.FLEET_WORKER_KILL == jfaults.FLEET_WORKER_KILL
    assert tfaults.FLEET_WORKER_KILL in tfaults.SITES
    # where JAX puts it: right before the result-cache poison site
    assert (tfaults.SITES.index(tfaults.CACHE_POISON)
            - tfaults.SITES.index(tfaults.FLEET_WORKER_KILL)) == 1
    assert (jfaults.SITES.index(jfaults.CACHE_POISON)
            - jfaults.SITES.index(jfaults.FLEET_WORKER_KILL)) == 1
    inj = tfaults.FaultInjector(seed=7).arm(tfaults.FLEET_WORKER_KILL, at=2)
    with inj:
        assert [tfaults.fires(tfaults.FLEET_WORKER_KILL) for _ in range(3)] \
            == [False, True, False]


# -------------------------------------------------------------- regress gate

def _all_tags():
    tags = {v for mod in (tmeas, jmeas) for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, str)}
    tags |= {t.lower() for t in tags}
    tags |= {"failover_ms", "cold_restart_ms", "failover", "replayn",
             "jdepth", "wincarn", "worker_restarts", "double_exec",
             "value", "vs_baseline", "slo_p99_ms", "admission_rejection_rate",
             "tuples_per_sec", "workers", "queries", "n", "speedup_x",
             "some_unknown_thing", "batch_fuse_ratio", "statusz_polls"}
    return sorted(tags)


def test_regress_directions_equal_jax():
    for tag in _all_tags():
        assert tregress.higher_is_better(tag) == jregress.higher_is_better(
            tag), tag
        assert tregress.tag_is_declared(tag) == jregress.tag_is_declared(
            tag), tag
    for tag in ("failover_ms", "cold_restart_ms", "failover", "replayn",
                "jdepth", "wincarn", "worker_restarts", "double_exec"):
        assert tregress.tag_is_declared(tag), tag
        assert not tregress.higher_is_better(tag), tag
    for tag in FLEET_TAGS:
        assert tregress.tag_is_declared(tag), tag
        assert not tregress.higher_is_better(tag), tag


def _tag_dicts(seed):
    rng = random.Random(seed)
    tags = _all_tags()
    base = {t: rng.choice([0.0, 1.0, rng.uniform(0.1, 100.0)])
            for t in rng.sample(tags, 40)}
    fresh = {t: (v * rng.uniform(0.5, 1.6) if rng.random() < 0.8 else 0.0)
             for t, v in base.items() if rng.random() < 0.9}
    fresh.update({t: rng.uniform(0, 5) for t in rng.sample(tags, 5)})
    return base, fresh


@pytest.mark.parametrize("seed", range(4))
def test_compare_tags_equal_jax(seed):
    base, fresh = _tag_dicts(seed)
    allow = sorted(base)[:3]
    thr = {sorted(base)[5]: 0.01}
    for kw in ({}, {"strict": True}, {"threshold": 0.05, "allow": allow,
                                      "tag_thresholds": thr}):
        got = tregress.compare_tags(base, fresh, **kw)
        assert got == jregress.compare_tags(base, fresh, **kw)
        assert tregress.format_table(got) == jregress.format_table(got)
        assert tregress.regressions(got) == jregress.regressions(got)


def test_extract_tags_and_thresholds_equal_jax():
    for obj in ({"workers": 4, "queries": 5, "failover_ms": 500.0,
                 "ok": True, "name": "x"},
                {"tags": {"JTOTAL": 3, "double_exec": 0}},
                {"parsed": {"tags": {"value": 2.5, "n": 3}}}):
        assert tregress.extract_tags(obj) == jregress.extract_tags(obj)
    tags = tregress.extract_tags({"workers": 4, "queries": 5,
                                  "failover_ms": 500.0})
    assert "workers" not in tags and "queries" not in tags
    specs = ["JTOTAL=0.10", "failover_ms=0.5"]
    assert tregress.parse_tag_thresholds(specs) == \
        jregress.parse_tag_thresholds(specs)
    for bad in (["JTOTAL"], ["=0.1"]):
        with pytest.raises(ValueError):
            tregress.parse_tag_thresholds(bad)


def test_double_exec_regresses_from_zero_at_any_threshold():
    for mod in (tregress, jregress):
        rows = mod.compare_tags({"double_exec": 0.0}, {"double_exec": 1.0},
                                threshold=1e9)
        assert [r["tag"] for r in rows
                if r["status"] == "regressed"] == ["double_exec"]
        assert not any(r["status"] == "regressed" for r in mod.compare_tags(
            {"double_exec": 0.0}, {"double_exec": 0.0}))


def test_check_result_and_files_equal_jax(tmp_path):
    base = tmp_path / "base.json"
    fresh = tmp_path / "fresh.json"
    empty = tmp_path / "empty.json"
    base.write_text(json.dumps({"failover_ms": 100.0, "double_exec": 0,
                                "tuples_per_sec": 10.0}))
    fresh.write_text(json.dumps({"failover_ms": 140.0, "double_exec": 0,
                                 "tuples_per_sec": 9.0}))
    empty.write_text("{}")
    for b in (base, empty):
        got = tregress.check_files(str(fresh), str(b))
        assert got == jregress.check_files(str(fresh), str(b))
    assert tregress.check_files(str(fresh), str(base))[0] == 1
    assert tregress.check_files(str(fresh), str(empty))[0] == 0


# --------------------------------------------------------------- command line

def _parse_error(fn, argv, capsys):
    with pytest.raises(SystemExit) as e:
        fn(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", [
    ["--fleet", "0", "--serve", "r.jsonl"],
    ["--fleet", "-1", "--serve", "-"],
    ["--fleet", "2"],
    ["--fleet", "x", "--serve", "-"],
    ["--fleet", "2", "--serve", "-", "--fleet-kill-at", "y"],
    ["--fleet", "2", "--serve", "-", "--rank-missed-beats", "0"],
], ids=["zero", "negative", "no_serve", "not_int", "kill_at_not_int",
        "missed_beats"])
def test_cli_fleet_parse_errors_equal_jax(argv, capsys):
    got = _parse_error(tmain, argv, capsys).split(": ", 1)[1]
    want = _parse_error(jmain, argv, capsys).split(": ", 1)[1]
    assert got == want


def test_cli_fleet_port_refusals(capsys):
    err = _parse_error(tmain, ["--fleet", "2", "--serve", "-", "--nodes",
                               "2"], capsys)
    assert "one-rank serve processes" in err
    # --elastic-join (refused by name until it was ported) is refused as
    # JAX refuses it: a supervisor is no mesh rank
    argv = ["--fleet", "2", "--serve", "-", "--elastic-join", "2"]
    err = _parse_error(tmain, argv, capsys)
    assert "cannot run as --elastic-join" in err
    assert err.split(": ", 1)[1] == \
        _parse_error(jmain, argv, capsys).split(": ", 1)[1]


def test_worker_args_pass_the_device_and_jax_shape():
    """Every worker gets the supervisor's --device (the card unless the
    caller asked for the CPU) and JAX's shape flags, in JAX's order."""
    p = build_parser()
    dflt = _fleet_worker_args(p.parse_args(["--fleet", "2", "--serve", "-"]))
    assert dflt[:4] == ["--nodes", "1", "--device", "cuda"]
    assert dflt[4:] == ["--profile", "h100", "--max-retries", "0",
                        "--fallback", "none", "--breaker-threshold", "3",
                        "--breaker-cooldown-s", "30.0",
                        "--serve-queue-depth", "64",
                        "--serve-tenant-quota", "8", "--place-cache-max", "8"]
    full = _fleet_worker_args(p.parse_args([
        "--fleet", "2", "--serve", "-", "--device", "cpu", "--verify",
        "check", "--serve-deadline-s", "9", "--result-cache", "4",
        "--result-cache-ttl-s", "60", "--batch-window-ms", "5",
        "--batch-max", "3", "--resident-budget-mb", "64"]))
    assert full[:6] == ["--nodes", "1", "--device", "cpu", "--verify",
                        "check"]
    assert full[-12:] == ["--serve-deadline-s", "9.0", "--result-cache", "4",
                          "--result-cache-ttl-s", "60.0",
                          "--batch-window-ms", "5.0", "--batch-max", "3",
                          "--resident-budget-mb", "64.0"]
    # every worker flag parses on the port's own command line
    p.parse_args(["--serve", "-", *full])


def test_card_heartbeat_carries_launch_counts(tmp_path, monkeypatch):
    """On the card a heartbeat line carries the process's kernel launch
    counts (how the fleet's workers show which kernels they ran); on the
    CPU it has none, so its lines stay JAX's."""
    import tpu_radix_join_torch.observability.metrics as met
    from tpu_radix_join_torch.ops import kernels

    path = str(tmp_path / "0.metrics.jsonl")
    cpu = met.MetricsSampler(path, interval_s=3600.0, device="cpu")
    assert "launches" not in cpu.sample()
    monkeypatch.setattr(met, "device_memory",
                        lambda device=None: {"device0_bytes_in_use": 8})
    monkeypatch.setitem(kernels.LAUNCHES, "radix_pass", 4)
    card = met.MetricsSampler(path, interval_s=3600.0, device="cuda")
    card.start()
    card.stop()
    lines = met.load_samples(path)
    assert len(lines) == 2
    assert all(ln["launches"] == kernels.launch_counts() for ln in lines)
    assert lines[-1]["launches"]["radix_pass"] == 4
