"""The device-init fallback of the port (``robustness/degrade.
engine_with_cpu_fallback``, the ``engine.device_init`` fault site and
``main --cpu-fallback``) against the JAX package's
(``tests/test_robustness.py:265-286`` and ``main.py:1633-1645``): the
armed site degrades with the fallback, raises without it, and a healthy
construction stays on its device; the ``[DEGRADE]`` line equals JAX's.
Only construction is wrapped: a kernel failure inside the join raises
with the fallback on."""

import io
import contextlib
import warnings

import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.core.config import JoinConfig as JJoinConfig  # noqa: E402
from tpu_radix_join.main import main as jax_main  # noqa: E402
from tpu_radix_join.performance.measurements import (  # noqa: E402
    Measurements as JMeasurements)
from tpu_radix_join.robustness import degrade as jdegrade  # noqa: E402
from tpu_radix_join.robustness import faults as jfaults  # noqa: E402

from tpu_radix_join_torch import HashJoin, JoinConfig, Relation  # noqa: E402
from tpu_radix_join_torch.main import REFUSED_FLAGS  # noqa: E402
from tpu_radix_join_torch.main import main as tx_main  # noqa: E402
from tpu_radix_join_torch.ops.kernels import radix_sort  # noqa: E402
from tpu_radix_join_torch.performance.measurements import (  # noqa: E402
    Measurements)
from tpu_radix_join_torch.robustness import faults as tfaults  # noqa: E402
from tpu_radix_join_torch.robustness.degrade import (  # noqa: E402
    engine_with_cpu_fallback)


def _rels(n=4096):
    return (Relation(n, 1, "unique", seed=1),
            Relation(n, 1, "zipf", seed=2, zipf_theta=0.75))


def test_device_init_site_equals_jax():
    assert tfaults.DEVICE_INIT == jfaults.DEVICE_INIT == "engine.device_init"
    assert tfaults.DEVICE_INIT in tfaults.SITES
    assert "--cpu-fallback" not in REFUSED_FLAGS
    with tfaults.FaultInjector() as inj:
        inj.arm(tfaults.DEVICE_INIT, at=1)
        with pytest.raises(tfaults.InjectedFault, match="device_init"):
            HashJoin(JoinConfig(), device="cpu")   # the first statement
        HashJoin(JoinConfig(), device="cpu")
    assert inj.hits(tfaults.DEVICE_INIT) == 2


def test_device_init_fault_degrades_to_cpu_as_jax():
    m, jm = Measurements(), JMeasurements()
    with jfaults.FaultInjector() as jinj:
        jinj.arm(jfaults.DEVICE_INIT, at=1)
        with pytest.warns(RuntimeWarning, match=r"\[DEGRADE\]"):
            _, jinfo = jdegrade.engine_with_cpu_fallback(
                JJoinConfig(num_nodes=1), measurements=jm)
    with tfaults.FaultInjector() as inj:
        inj.arm(tfaults.DEVICE_INIT, at=1)
        with pytest.warns(RuntimeWarning, match=r"\[DEGRADE\]"):
            engine, info = engine_with_cpu_fallback(
                JoinConfig(), device="cpu", measurements=m)
    assert info == jinfo
    assert info["degraded"] and info["backend"] == "cpu"
    assert info["failure_class"] == "device_unavailable"
    assert inj.hits(tfaults.DEVICE_INIT) == 2   # primary + the CPU engine
    assert engine.device.type == "cpu"
    degrade = [(e, d) for e, d in m.events if e == "degrade"]
    assert degrade == [("degrade", {"to": "cpu", "num_nodes": 1,
                                    "error": info["error"]})]
    r, s = _rels()
    res = engine.join(r, s)
    assert res.ok and res.matches == 4096


def test_no_card_degrades_and_a_healthy_engine_stays():
    with pytest.warns(RuntimeWarning, match=r"no CUDA device"):
        engine, info = engine_with_cpu_fallback(
            JoinConfig(num_nodes=2, num_hosts=2))
    assert info["degraded"] and info["num_nodes"] == 1
    assert engine.config.num_nodes == engine.config.num_hosts == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        engine, info = engine_with_cpu_fallback(JoinConfig(), device="cpu")
    _, jinfo = jdegrade.engine_with_cpu_fallback(JJoinConfig(num_nodes=1))
    assert info == jinfo == {"degraded": False, "backend": "cpu"}
    assert engine.config == JoinConfig()


def test_without_the_fallback_the_fault_raises():
    with tfaults.FaultInjector() as inj:
        inj.arm(tfaults.DEVICE_INIT, at=1)
        with pytest.raises(tfaults.InjectedFault):
            tx_main(["--device", "cpu", "--tuples-per-node", "4096"])


def test_a_kernel_failure_inside_the_join_still_raises(monkeypatch):
    engine, info = engine_with_cpu_fallback(JoinConfig(), device="cpu")
    assert not info["degraded"]

    def broken(*a, **kw):
        raise RuntimeError("radix_pass launch failed")

    monkeypatch.setattr(radix_sort, "radix_sort_plain", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        engine.join(*_rels())
    with pytest.raises(RuntimeError, match="launch failed"):
        tx_main(["--device", "cpu", "--cpu-fallback",
                 "--tuples-per-node", "4096"])


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rc = main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def test_main_degrade_line_equals_jax():
    argv = ["--cpu-fallback", "--nodes", "1", "--tuples-per-node", "4096"]
    with jfaults.FaultInjector() as jinj:
        jinj.arm(jfaults.DEVICE_INIT, at=1)
        jrc, jout, jerr = _run(jax_main, argv)
    with tfaults.FaultInjector() as inj:
        inj.arm(tfaults.DEVICE_INIT, at=1)
        rc, out, err = _run(tx_main, ["--device", "cpu", *argv])
    line = [x for x in err if x.startswith("[DEGRADE] ")]
    assert line == [x for x in jerr if x.startswith("[DEGRADE] ")]
    assert line == ["[DEGRADE] failure_class=device_unavailable backend=cpu "
                    "nodes=1 error=InjectedFault(\"injected fault at "
                    "'engine.device_init' (hit 1)\")"]
    assert rc == jrc == 0
    results = [x for x in out if x.startswith("[RESULTS] ")]
    assert results[:3] == [x for x in jout if x.startswith("[RESULTS] ")][:3]
    assert "[RESULTS] Expected: 4096 (OK)" in results
    if torch.cuda.is_available():
        return
    # the same argv on a host with no card: the card's construction fails
    rc, out, err = _run(tx_main, argv)
    assert rc == 0 and any(x.startswith("[DEGRADE] failure_class="
                                        "device_unavailable backend=cpu "
                                        "nodes=1 error=RuntimeError(")
                           for x in err)
