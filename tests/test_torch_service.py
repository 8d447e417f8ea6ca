"""The service's building blocks of the port against the JAX package's:
deadlines, admission, the circuit breaker, SLO percentiles, the retry
predicate, ``ServiceConfig`` (and ``state.service_config_from_jax``), the
plan cache with its profile and plan, and the engine's hooks — the warm
start from the plan cache (no JHIST) and the cancel hook's boundaries.
JAX's own test cases (``tests/test_service.py``), each run against both
packages' objects on the same fake clock."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import tpu_radix_join as jx  # noqa: E402
import tpu_radix_join.service as jsvc  # noqa: E402
from tpu_radix_join.core.config import (  # noqa: E402
    ServiceConfig as JServiceConfig)
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.planner import PlanCache as JPlanCache  # noqa: E402
from tpu_radix_join.planner import load_profile as j_load_profile  # noqa
from tpu_radix_join.planner.plan import JoinPlan as JJoinPlan  # noqa: E402
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402
from tpu_radix_join.robustness import retry as jretry  # noqa: E402

import tpu_radix_join_torch as tx  # noqa: E402
import tpu_radix_join_torch.service as tsvc  # noqa: E402
from tpu_radix_join_torch.core.config import ServiceConfig  # noqa: E402
from tpu_radix_join_torch.performance import Measurements  # noqa: E402
from tpu_radix_join_torch.planner import (JoinPlan, ManifestMismatch,  # noqa
                                          PlanCache, PlanError,
                                          ProfileError, load_profile)
from tpu_radix_join_torch.robustness import faults as tfaults  # noqa: E402
from tpu_radix_join_torch.robustness import retry as tretry  # noqa: E402
from tpu_radix_join_torch.state import service_config_from_jax  # noqa: E402

PKGS = {"port": (tsvc, tretry, ServiceConfig),
        "jax": (jsvc, jretry, JServiceConfig)}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _Req:
    def __init__(self, tenant="default", query_id="q"):
        self.tenant = tenant
        self.query_id = query_id


# ---------------------------------------------------------------- deadlines

@pytest.mark.parametrize("pkg", PKGS)
def test_deadline_expires_with_fake_clock(pkg):
    svc, retry, _ = PKGS[pkg]
    clock = FakeClock()
    d = svc.Deadline(1.0, clock=clock)
    d.check("early")
    clock.advance(0.5)
    assert d.remaining_s() == pytest.approx(0.5)
    clock.advance(0.6)
    with pytest.raises(svc.DeadlineExceeded) as ei:
        d.check("probe")
    assert ei.value.failure_class == retry.DEADLINE_EXCEEDED
    assert ei.value.phase == "probe"
    assert ei.value.elapsed_s == pytest.approx(1.1)
    assert str(ei.value) == ("deadline 1.000s exceeded after 1.100s "
                             "(at phase 'probe')")


@pytest.mark.parametrize("pkg", PKGS)
def test_deadline_unlimited_and_negative(pkg):
    svc = PKGS[pkg][0]
    clock = FakeClock()
    d = svc.Deadline(None, clock=clock)
    clock.advance(1e9)
    d.check("whenever")
    assert not d.expired() and d.remaining_s() is None
    svc.Deadline.unlimited().check()
    with pytest.raises(ValueError):
        svc.Deadline(-1.0)


# ---------------------------------------------------------------- admission

def _admission_script(pkg):
    svc, retry, _ = PKGS[pkg]
    log = []
    q = svc.AdmissionQueue(max_depth=2, tenant_quota=8)
    q.submit(_Req())
    q.submit(_Req())
    with pytest.raises(svc.AdmissionRejected) as ei:
        q.submit(_Req())
    log += [ei.value.failure_class, ei.value.reason, str(ei.value),
            q.rejected, q.admitted]
    q = svc.AdmissionQueue(max_depth=16, tenant_quota=2)
    q.submit(_Req("noisy"))
    q.submit(_Req("noisy"))
    with pytest.raises(svc.AdmissionRejected) as ei:
        q.submit(_Req("noisy"))
    q.submit(_Req("quiet"))
    log += [ei.value.reason, str(ei.value), q.tenant_load("noisy"),
            len(q)]
    q = svc.AdmissionQueue(max_depth=16, tenant_quota=1)
    r = _Req("t")
    q.submit(r)
    log.append(q.pop() is r and q.depth() == 0)
    with pytest.raises(svc.AdmissionRejected):
        q.submit(_Req("t"))
    q.done(r)
    q.submit(_Req("t"))
    log.append(q.rejection_rate())
    for kw in ({"max_depth": 0}, {"tenant_quota": 0}):
        with pytest.raises(ValueError):
            svc.AdmissionQueue(**kw)
    return log


def test_admission_queue_equals_jax():
    port = _admission_script("port")
    assert port == _admission_script("jax")
    assert port[0] == "admission_rejected" and port[1] == "queue_full"
    assert port[5] == "tenant_quota"
    assert port[-1] == pytest.approx(1 / 3)


def test_admission_counters_equal_jax():
    got = []
    for svc, Meas in ((tsvc, Measurements), (jsvc, JMeasurements)):
        m = Meas()
        q = svc.AdmissionQueue(max_depth=1, measurements=m)
        q.submit(_Req())
        with pytest.raises(svc.AdmissionRejected):
            q.submit(_Req(query_id="x"))
        got.append((m.counters.get("QADMIT"), m.counters.get("QREJECT"),
                    [e for e in m.meta["events"]
                     if e["event"] == "admission_rejected"][0]["reason"]))
    assert got[0] == got[1] == (1, 1, "queue_full")


# ------------------------------------------------------------------ breaker

def _breaker_script(pkg):
    svc, retry, _ = PKGS[pkg]
    Meas = Measurements if pkg == "port" else JMeasurements
    log = []
    clock = FakeClock()
    m = Meas()
    b = svc.CircuitBreaker(failure_threshold=3, cooldown_s=10.0, clock=clock,
                           measurements=m)
    for _ in range(2):
        b.record_failure(retry.BACKEND_UNAVAILABLE)
    b.record_success()
    for _ in range(2):
        b.record_failure(retry.BACKEND_UNAVAILABLE)
    log.append(b.state)
    log += [b.record_failure(retry.BACKEND_UNAVAILABLE), b.state, b.trips]
    b2 = svc.CircuitBreaker(failure_threshold=2, cooldown_s=10.0,
                            clock=FakeClock())
    b2.record_failure(retry.BACKEND_UNAVAILABLE)
    b2.record_failure(retry.CAPACITY_OVERFLOW)
    b2.record_failure(retry.BACKEND_UNAVAILABLE)
    b2.record_failure(retry.DATA_CORRUPTION)
    b2.record_failure(retry.DEADLINE_EXCEEDED)
    log += [b2.state, b2.trips]
    clock = FakeClock()
    b3 = svc.CircuitBreaker(failure_threshold=1, cooldown_s=5.0, clock=clock,
                            measurements=m)
    b3.record_failure(retry.BACKEND_UNAVAILABLE)
    log += [b3.state, b3.allow_primary()]
    clock.advance(5.1)
    log += [b3.allow_primary(), b3.state, b3.probes]
    b3.record_success()
    log.append(b3.state)
    b3.record_failure(retry.BACKEND_UNAVAILABLE)
    clock.advance(5.1)
    log += [b3.allow_primary(), b3.record_failure(retry.BACKEND_UNAVAILABLE),
            b3.state, b3.trips, b3.allow_primary(), b3.snapshot()]
    for kw in ({"failure_threshold": 0}, {"cooldown_s": -1.0}):
        with pytest.raises(ValueError):
            svc.CircuitBreaker(**kw)
    events = [{k: v for k, v in e.items() if k not in ("t_s", "t_epoch_s")}
              for e in m.meta["events"]]
    return log, events, {k: m.counters.get(k, 0)
                         for k in ("BRKTRIP", "BRKPROBE")}


def test_circuit_breaker_equals_jax():
    port = _breaker_script("port")
    assert port == _breaker_script("jax")
    log = port[0]
    assert log[:4] == ["closed", True, "open", 1]
    assert log[4:6] == ["closed", 0]
    assert port[2] == {"BRKTRIP": 4, "BRKPROBE": 2}


# ---------------------------------------------------------------------- slo

@pytest.mark.parametrize("pkg", PKGS)
def test_slo_snapshot_and_nearest_rank(pkg):
    svc, retry, _ = PKGS[pkg]
    vals = [1.0, 2.0, 3.0, 4.0, 5.0]
    assert svc.nearest_rank(vals, 50) == 3.0
    assert svc.nearest_rank(vals, 99) == 5.0
    with pytest.raises(ValueError):
        svc.nearest_rank([], 50)
    s = svc.SLORecorder()
    assert "slo_p50_ms" not in s.snapshot()
    for ms in (10.0, 20.0, 30.0):
        s.record("a", ms, ok=True)
    s.record("b", 100.0, ok=False, failure_class=retry.DEADLINE_EXCEEDED)
    s.record("b", 50.0, ok=True, degraded=True)
    s.record_rejection()
    snap = s.snapshot()
    assert snap["queries_submitted"] == 6
    assert snap["slo_p50_ms"] == 30.0 and snap["slo_b_p99_ms"] == 100.0
    assert snap["degraded_rate"] == pytest.approx(1 / 6, abs=1e-3)
    other = (jsvc if svc is tsvc else tsvc).SLORecorder()
    for ms in (10.0, 20.0, 30.0):
        other.record("a", ms, ok=True)
    other.record("b", 100.0, ok=False, failure_class="deadline_exceeded")
    other.record("b", 50.0, ok=True, degraded=True)
    other.record_rejection()
    assert other.snapshot() == snap


# -------------------------------------------------- retryability predicate

@pytest.mark.parametrize("pkg", PKGS)
def test_retry_policy_cases(pkg):
    _, r, _ = PKGS[pkg]
    assert r.is_retryable_class(r.CAPACITY_OVERFLOW)
    assert r.is_retryable_class(r.BACKEND_UNAVAILABLE)
    assert r.is_retryable_class(r.COORDINATOR_TIMEOUT)
    for cls in (r.KEY_CONTRACT, r.DATA_CORRUPTION, r.ADMISSION_REJECTED,
                r.DEADLINE_EXCEEDED):
        assert not r.is_retryable_class(cls)
    sizing = r.RetryPolicy(retryable_classes=r.RETRYABLE_SIZING)
    assert r.is_retryable_class(r.CAPACITY_OVERFLOW, sizing)
    assert not r.is_retryable_class(r.BACKEND_UNAVAILABLE, sizing)
    custom = r.RetryPolicy(retryable_classes=frozenset({r.KEY_CONTRACT}))
    assert r.is_retryable_class(r.KEY_CONTRACT, custom)
    assert not r.is_retryable_class(r.CAPACITY_OVERFLOW, custom)


def test_retry_vocabulary_equals_jax():
    for name in ("BACKEND_UNAVAILABLE", "DEADLINE_EXCEEDED",
                 "ADMISSION_REJECTED", "RETRIES_EXHAUSTED",
                 "DEVICE_UNAVAILABLE"):
        assert getattr(tretry, name) == getattr(jretry, name)
    assert tretry.DEFAULT_RETRYABLE == jretry.DEFAULT_RETRYABLE
    assert tsvc.breaker.DEFAULT_TRIPPING == jsvc.breaker.DEFAULT_TRIPPING
    for site in ("BACKEND_DISPATCH", "BACKEND_STALL", "CACHE_POISON"):
        assert getattr(tfaults, site) == getattr(jfaults, site)
        assert getattr(tfaults, site) in tfaults.SITES


# ----------------------------------------------------------- service config

@pytest.mark.parametrize("pkg", PKGS)
def test_service_config_validates_and_replaces(pkg):
    cfg_cls = PKGS[pkg][2]
    svc = cfg_cls()
    assert svc.max_queue_depth == 64 and svc.breaker_threshold == 3
    narrowed = svc.replace(tenant_quota=2, default_deadline_s=1.5)
    assert narrowed.tenant_quota == 2 and narrowed.default_deadline_s == 1.5
    for kw in ({"max_queue_depth": 0}, {"breaker_cooldown_s": -1.0},
               {"default_deadline_s": -0.1}, {"tenant_quota": 0},
               {"breaker_threshold": 0}, {"outcomes_keep": 0},
               {"place_cache_max": -1}, {"result_cache_max": -1},
               {"result_cache_ttl_s": 0.0}, {"batch_window_ms": -1.0},
               {"batch_max_queries": 1}, {"resident_budget_bytes": -1}):
        with pytest.raises(ValueError):
            cfg_cls(**kw)


def test_service_config_carries_across():
    j = JServiceConfig(max_queue_depth=5, result_cache_max=3,
                       batch_window_ms=2.5, resident_budget_bytes=1 << 20,
                       default_deadline_s=0.25)
    assert dataclasses.asdict(service_config_from_jax(
        dataclasses.asdict(j))) == dataclasses.asdict(j)
    assert dataclasses.asdict(ServiceConfig()) == dataclasses.asdict(
        JServiceConfig())
    with pytest.raises(ValueError):
        service_config_from_jax({"fleet_workers": 2})


# --------------------------------------------------------------- planner

def test_profile_is_the_ports_own():
    prof = load_profile()
    assert prof.name == "h100"
    assert set(prof.constants) == set(j_load_profile().constants)
    card = prof.notes.split(";")[0]            # name, power limit
    tpu = j_load_profile()
    for key in prof.constants:
        if not prof.is_set(key):
            continue
        # measured on the card: cited to a calibration or a fit naming it,
        # and no TPU number
        assert prof.source(key).startswith(("calibrate:", "fit:"))
        assert "H100" in card and card in prof.source(key)
        assert prof.value(key) > 0 and prof.value(key) != tpu.value(key)
    for key in ("ici_gbps", "ici_bytes_per_s"):
        with pytest.raises(ProfileError, match="unset"):
            prof.value(key)                    # no interconnect measured
    with pytest.raises(ProfileError):
        load_profile("v5e_lite")


def test_join_plan_round_trip_equals_jax(tmp_path):
    jp = JJoinPlan(engine="incore", probe="bucket", strategy="bucket",
                   predicted_ms=3.5, predicted_terms={"sort": 1.0})
    tp = JoinPlan.from_dict(jp.to_dict())
    assert tp.to_dict() == jp.to_dict()
    assert JoinPlan.load(tp.save(str(tmp_path / "p.json"))) == tp
    for doc in ({"engine": "gpu"}, {"engine": "incore", "x": 1},
                {"engine": "incore", "schema_version": 99}):
        with pytest.raises(PlanError):
            JoinPlan.from_dict(doc)


def test_plan_cache_lookup_store_hot_layer_and_manifest(tmp_path):
    got = []
    for cache_cls, prof, Meas in (
            (PlanCache, load_profile(), Measurements),
            (JPlanCache, j_load_profile(), JMeasurements)):
        d = tmp_path / cache_cls.__module__.split(".")[0]
        m = Meas()
        cache = cache_cls(str(d), prof, measurements=m)
        fp = {"num_nodes": 1}
        log = [cache.lookup(8, 8, fp)]
        log.append(cache.store(8, 8, fp, capacities={"cap_r": 16,
                                                     "cap_s": 32}))
        log.append(cache.lookup(8, 8, fp))            # hot
        cold = cache_cls(str(d), prof, measurements=m)
        log.append(cold.lookup(8, 8, fp))             # from disk
        log.append(cold.lookup(8, 9, fp))             # another shape
        cache.write_manifest(2)
        cache.check_manifest(2)
        with pytest.raises(ValueError):
            cache.check_manifest(4)
        log.append(m.counters.get("CKPTLOAD", 0))
        log.append(sorted(e["event"] for e in m.meta["events"]))
        got.append(log)
    assert got[0] == got[1]
    assert got[0][2] == (None, {"cap_r": 16, "cap_s": 32})
    assert got[0][-2] == 1
    with pytest.raises(ManifestMismatch):
        PlanCache(str(tmp_path / "tpu_radix_join_torch"),
                  load_profile()).check_manifest(3)


# --------------------------------------------------------- engine hooks

def _join(pkg, cfg_kw, cache_dir=None, cancel=None, repeat=1):
    """(phases seen by the cancel hook, results, registry) of ``repeat``
    joins of 4096 unique tuples a side at one rank."""
    if pkg == "port":
        m = Measurements()
        cache = (PlanCache(cache_dir, load_profile(), measurements=m)
                 if cache_dir else None)
        eng = tx.HashJoin(tx.JoinConfig(**cfg_kw), device="cpu",
                          measurements=m, plan_cache=cache)
        rels = (tx.Relation(4096, 1, "unique", seed=1),
                tx.Relation(4096, 1, "unique", seed=2))
    else:
        m = JMeasurements()
        cache = (JPlanCache(cache_dir, j_load_profile(), measurements=m)
                 if cache_dir else None)
        eng = jx.HashJoin(jx.JoinConfig(num_nodes=1, **cfg_kw),
                          measurements=m, plan_cache=cache)
        rels = (jx.Relation(4096, 1, "unique", seed=1),
                jx.Relation(4096, 1, "unique", seed=2))
    phases = []
    eng.cancel = cancel or phases.append
    results = [eng.join(*rels) for _ in range(repeat)]
    return phases, results, m


@pytest.mark.parametrize("cfg_kw", [{}, {"probe_algorithm": "bucket"},
                                    {"two_level": True}])
def test_cancel_hook_boundaries_equal_jax(cfg_kw):
    got = []
    for pkg, faults in (("port", tfaults), ("jax", jfaults)):
        inj = faults.FaultInjector(seed=2)
        inj.arm(faults.SHUFFLE_OVERFLOW, at=1)
        with inj:
            phases, res, _ = _join(pkg, dict(cfg_kw, max_retries=1))
        got.append((phases, [(r.matches, r.ok) for r in res]))
    assert got[0] == got[1]
    assert got[0][0] == ["start", "sized", "probe", "probe"]


@pytest.mark.parametrize("phase", ["start", "sized", "probe"])
def test_cancel_raises_at_its_boundary_and_closes_jtotal(phase):
    class Stop(RuntimeError):
        pass

    def cancel(p):
        if p == phase:
            raise Stop(p)

    for pkg in ("port", "jax"):
        with pytest.raises(Stop):
            _join(pkg, {"probe_algorithm": "bucket"}, cancel=cancel)
    _, _, m = _join("port", {}, cancel=lambda p: None)
    with pytest.raises(Stop):
        eng_m = Measurements()
        eng = tx.HashJoin(tx.JoinConfig(probe_algorithm="bucket"),
                          device="cpu", measurements=eng_m)
        eng.cancel = cancel
        eng.join(tx.Relation(1024, 1, "unique", seed=1),
                 tx.Relation(1024, 1, "unique", seed=2))
    assert "JTOTAL" not in eng_m._starts
    assert (("JTOTAL" in eng_m.times_us) == (phase != "start"))


def test_warm_start_skips_the_sizing_pass_equal_jax(tmp_path):
    got = []
    for pkg in ("port", "jax"):
        d = str(tmp_path / pkg)
        _, res, m = _join(pkg, {"probe_algorithm": "bucket"}, d, repeat=1)
        jhist = m.times_us.get("JHIST", 0.0)
        # a second engine over the same directory: the entry from disk
        _, res2, m2 = _join(pkg, {"probe_algorithm": "bucket"}, d, repeat=2)
        got.append(([r.matches for r in res + res2], jhist > 0,
                     "JHIST" in m2.times_us, m2.counters.get("CKPTLOAD", 0)))
        with open(next((tmp_path / pkg).glob("plan_*.json"))) as f:
            caps = json.load(f)["capacities"]
        got[-1] += (caps,)
    assert got[0][:4] == got[1][:4] == ([4096] * 3, True, False, 1)
    assert got[0][4] == {"cap_r": 4096, "cap_s": 4096, "local_slack": 1}


def test_sort_probe_at_one_rank_is_not_cache_eligible(tmp_path):
    _, _, m = _join("port", {}, str(tmp_path), repeat=2)
    assert not list(tmp_path.glob("plan_*.json"))
    assert "JHIST" not in m.times_us


def test_stall_site_ends_at_the_cancel_hook_or_its_cap(monkeypatch):
    class Stop(RuntimeError):
        pass

    seen = []

    def cancel(p):
        seen.append(p)
        if seen.count("stalled") == 3:
            raise Stop(p)

    inj = tfaults.FaultInjector()
    inj.arm(tfaults.BACKEND_STALL, at=1)
    with inj, pytest.raises(Stop):
        _join("port", {"probe_algorithm": "bucket"}, cancel=cancel)
    assert seen == ["start", "sized", "stalled", "stalled", "stalled"]
    monkeypatch.setenv("TPU_RADIX_STALL_CAP_S", "0")
    inj = tfaults.FaultInjector()
    inj.arm(tfaults.BACKEND_STALL, at=1)
    with inj, pytest.raises(tfaults.TransientFault) as ei:
        _join("port", {})
    assert ei.value.failure_class == "backend_unavailable"
