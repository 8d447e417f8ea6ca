"""The port's sanctioned sync points (``utils/hostsync.py``): the readback
equals the JAX package's on the same inputs; the guard arms, pauses and
restores ``torch.cuda``'s process-global sync debug mode (recorded here by
a stand-in, since the CPU build has none) through nesting, exceptions and
two threads; and ``--transfer-guard`` is a flag of the command line that
refuses the CPU."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_radix_join.utils.hostsync import host_readback as jax_readback  # noqa: E402,E501
from tpu_radix_join_torch import main as tmain  # noqa: E402
from tpu_radix_join_torch.utils import hostsync  # noqa: E402
from tpu_radix_join_torch.utils.hostsync import (host_fence,  # noqa: E402
                                                 host_readback, host_upload,
                                                 sync_guard)

import jax.numpy as jnp  # noqa: E402


def _inputs(seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-2**31, 2**31, size=97, dtype=np.int64).astype(np.int32)
    b = rng.random((5, 7)).astype(np.float32)
    c = rng.random(13) < 0.5
    return a, b, c


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_readback_equals_jax(seed):
    a, b, c = _inputs(seed)
    cases = [
        (torch.from_numpy(a), jnp.asarray(a)),
        (torch.from_numpy(b), jnp.asarray(b)),
        (torch.from_numpy(c), jnp.asarray(c)),
        (a, a),                                     # numpy passes through
        (torch.tensor(int(a[0]), dtype=torch.int32), jnp.asarray(a[0])),
        (7, 7),
        ([torch.from_numpy(a[:3]), torch.from_numpy(a[3:6])],
         [jnp.asarray(a[:3]), jnp.asarray(a[3:6])]),
    ]
    for port_in, jax_in in cases:
        got, want = host_readback(port_in), jax_readback(jax_in)
        assert isinstance(got, np.ndarray)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the uint32 lanes stay int32 bit patterns: callers view them
    lane = torch.from_numpy(a)
    np.testing.assert_array_equal(host_readback(lane).view(np.uint32),
                                  a.view(np.uint32))


def test_host_upload_and_fence_on_the_cpu(monkeypatch):
    calls = _modes(monkeypatch).calls
    a = np.arange(5, dtype=np.int32)
    t = host_upload(a, "cpu", torch.int64)
    assert t.dtype == torch.int64 and t.tolist() == [0, 1, 2, 3, 4]
    host_fence(torch.device("cpu"))       # nothing to wait for
    host_readback(t)
    assert calls == []                    # no guard: the mode is untouched


class _Modes:
    """A stand-in for c10's process-global sync debug mode."""

    def __init__(self):
        self.mode = 0
        self.calls = []
        self.lock = threading.Lock()

    def set(self, mode):
        with self.lock:
            self.mode = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)
            self.calls.append(self.mode)

    def get(self):
        return self.mode


def _modes(monkeypatch):
    """The stand-in, installed for one test."""
    modes = _Modes()
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.set)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", modes.get)
    return modes


def test_guard_arms_pauses_and_restores(monkeypatch):
    modes = _modes(monkeypatch)
    with sync_guard("disallow"):
        assert modes.mode == 2 and hostsync._ARMED
        host_readback(torch.arange(3))        # paused for its copy only
        assert modes.mode == 2
    assert modes.mode == 0 and not hostsync._ARMED
    assert modes.calls == [2, 0, 2, 0]
    with sync_guard("log"):
        assert modes.mode == 1
    with sync_guard("off"):
        assert modes.mode == 0
    assert modes.calls == [2, 0, 2, 0, 1, 0]


def test_guard_restores_the_mode_it_found(monkeypatch):
    modes = _modes(monkeypatch)
    modes.mode = 1                             # armed by someone else
    with sync_guard("disallow"):
        assert modes.mode == 2
    assert modes.mode == 1


def test_guard_nests(monkeypatch):
    modes = _modes(monkeypatch)
    with sync_guard("disallow"):
        with sync_guard("log"):
            assert modes.mode == 1
            host_readback([torch.arange(2)])
            assert modes.mode == 1
        assert modes.mode == 2
    assert modes.mode == 0
    assert modes.calls == [2, 1, 0, 1, 2, 0]


def test_guard_restores_after_an_exception(monkeypatch):
    modes = _modes(monkeypatch)
    with pytest.raises(KeyError):
        with sync_guard("disallow"):
            with sync_guard("log"):
                raise KeyError("inside the join")
    assert modes.mode == 0 and not hostsync._ARMED
    with pytest.raises(ValueError):
        with sync_guard("loud"):
            pass
    assert modes.mode == 0


def test_guard_and_pauses_on_two_threads(monkeypatch):
    """A pause on one thread disarms the process for its copy; the last
    pause to end re-arms the innermost open guard, and a guard that closed
    meanwhile is not re-armed by it."""
    modes = _modes(monkeypatch)
    entered, release, done = (threading.Event(), threading.Event(),
                              threading.Event())

    def other_thread():
        with hostsync._paused():
            entered.set()
            release.wait(5)
        done.set()

    # a pause that spans the guard's close leaves the mode restored
    with sync_guard("disallow"):
        t = threading.Thread(target=other_thread)
        t.start()
        assert entered.wait(5) and modes.mode == 0
    assert modes.mode == 0
    release.set()
    t.join(5)
    assert done.is_set() and modes.mode == 0

    # a guard opened during another thread's pause arms when it ends
    entered.clear(), release.clear(), done.clear()
    t = threading.Thread(target=other_thread)
    t.start()
    assert entered.wait(5)
    with sync_guard("disallow"):
        assert modes.mode == 0                 # still paused
        with hostsync._paused():               # nested pause, this thread
            assert modes.mode == 0
        assert modes.mode == 0
        release.set()
        t.join(5)
        assert modes.mode == 2                 # the last pause re-armed
    assert modes.mode == 0

    # many readbacks on a worker while a guard is open end armed
    errors = []

    def readbacks():
        try:
            for _ in range(200):
                host_readback(torch.arange(4))
        except Exception as e:   # noqa: BLE001
            errors.append(e)

    with sync_guard("log"):
        workers = [threading.Thread(target=readbacks) for _ in range(2)]
        for w in workers:
            w.start()
        for _ in range(200):
            host_readback(torch.arange(4))
        for w in workers:
            w.join(10)
        assert modes.mode == 1 and not errors
    assert modes.mode == 0


def test_guard_without_cuda_is_not_a_silent_no_op():
    """On a build without CUDA the guard raises (no mode to arm) instead
    of pretending to guard."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA build arms the mode for real")
    with pytest.raises((AssertionError, RuntimeError)):
        with sync_guard("disallow"):
            pass
    assert not hostsync._ARMED


# ------------------------------------------------------------ command line
def test_transfer_guard_left_the_refused_flags():
    assert "--transfer-guard" not in tmain.REFUSED_FLAGS
    p = tmain.build_parser()
    assert p.parse_args([]).transfer_guard == "off"
    assert p.parse_args(["--transfer-guard", "disallow"]).transfer_guard \
        == "disallow"
    with pytest.raises(SystemExit):
        p.parse_args(["--transfer-guard", "loud"])


@pytest.mark.parametrize("mode", ["log", "disallow"])
def test_transfer_guard_on_the_cpu_is_a_parser_error(mode, capsys):
    with pytest.raises(SystemExit) as e:
        tmain.main(["--device", "cpu", "--transfer-guard", mode,
                    "--tuples-per-node", "1024"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--transfer-guard" in err and "CUDA device" in err


def test_transfer_guard_arms_around_the_join_only(monkeypatch, capsys):
    """The guard wraps the join, not generation or placement: a run with
    ``--transfer-guard`` and a stand-in guard records the join's phase."""
    seen = []
    import contextlib

    @contextlib.contextmanager
    def fake_guard(mode):
        seen.append(("enter", mode))
        yield
        seen.append(("exit", mode))

    monkeypatch.setattr(tmain, "sync_guard", fake_guard)
    rc = tmain.main(["--device", "cpu", "--tuples-per-node", "2048"])
    assert rc == 0 and seen == [("enter", "off"), ("exit", "off")]
    capsys.readouterr()
