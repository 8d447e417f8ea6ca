"""The port's lint (``tpu_radix_join_torch/analysis``): every rule fires on
a PyTorch spelling and passes its sanctioned one, waivers need a reason
and a rule's own token, the baseline rejects reasonless and unknown-rule
entries and reports stale ones, the framework-neutral rules give the same
findings and exit codes as the JAX package's core on the same sources, and
the port's own tree lints clean under ``--strict``."""

import json
import os
import textwrap

import pytest

pytest.importorskip("torch")

from tpu_radix_join.analysis import core as jcore  # noqa: E402
from tpu_radix_join.analysis import register_builtin_rules as jregister  # noqa: E402,E501
from tpu_radix_join_torch.analysis import (LintError,  # noqa: E402
                                           default_baseline,
                                           register_builtin_rules, run_lint)
from tpu_radix_join_torch.tools import lint as tlint  # noqa: E402

register_builtin_rules()
jregister()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "tpu_radix_join_torch"


def _lint(tmp_path, rel, code, rules, baseline=None, runner=run_lint):
    """Lint one synthetic file at ``rel`` under a tmp root: (findings in
    that file, LintResult)."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    res = runner(str(tmp_path), rule_ids=rules, baseline_path=baseline,
                 paths=[str(path)])
    return [f for f in res.findings if f.path == rel], res


_THREADED = """
    import threading

    class Worker:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0

        def start(self):
            self._t = threading.Thread(target=self._loop)
            self._t.start()

        def _loop(self):
            {body}
"""

_CYCLE = """
    import threading

    class MetricsSampler:
        def __init__(self):
            self._lock = threading.Lock()
            self._board = LeaseBoard()

        def tick(self):
            with self._lock:
                self._board.heartbeat()

    class LeaseBoard:
        def __init__(self):
            self._lock = threading.Lock()
            self._sampler = MetricsSampler()

        def heartbeat(self):
            with self._lock:
                pass

        def report(self):
            with self._lock:
                self._sampler.tick()
"""

_ORDERED = """
    class AdmissionQueue:
        def submit(self):
            with self._lock:
                with self._brk_lock:
                    pass

        def drain(self):
            with self._lock:
                with self._brk_lock:
                    pass
"""

#: (rule, file, firing source, its keys, passing source): one firing and
#: one passing case a rule, in the port's spellings
CASES = [
    ("sort-bypass", f"{PKG}/planner/foo.py",
     "import torch\n"
     "def f(x):\n"
     "    a = torch.sort(x)\n"
     "    b = torch.argsort(x, stable=True)\n"
     "    return a, b, x.msort()\n",
     ["torch.sort", "torch.argsort", ".msort()"],
     "import numpy as np\n"
     "from tpu_radix_join_torch.ops.sorting import sort_unstable\n"
     "def f(x, rows):\n"
     "    rows.sort(key=len)\n"
     "    return sort_unstable(x), np.sort(x), sorted(rows)\n"),
    ("counter-tag", f"{PKG}/foo.py",
     "def f(m):\n"
     "    m.incr(\"TOTALLYNEWTAG\")\n",
     ["TOTALLYNEWTAG"],
     "from tpu_radix_join_torch.performance.measurements import SORTPASS\n"
     "def f(m, k):\n"
     "    m.incr(\"RTUPLES\", 4)\n"
     "    m.incr(SORTPASS)\n"
     "    m.start(\"JPROC\")\n"
     "    m.stop(k)\n"),
    ("failure-class", f"{PKG}/foo.py",
     "def f(g):\n"
     "    g(failure_class=\"oom\")\n"
     "    d = {\"failure_class\": \"rank-lost\"}\n"
     "    d[\"failure_class\"] = \"boom\"\n",
     ["boom", "oom", "rank-lost"],
     "from tpu_radix_join_torch.robustness.retry import RANK_LOST\n"
     "def f(g, cls):\n"
     "    g(failure_class=\"rank_lost\")\n"
     "    g(failure_class=\"unclassified\")\n"
     "    g(failure_class=RANK_LOST)\n"
     "    g(failure_class=cls)\n"),
    ("sync-point", f"{PKG}/ops/chunked.py",
     "import torch\n"
     "def _walk(x) -> torch.Tensor:\n"
     "    return x\n"
     "def g(x, n):\n"
     "    v = _walk(x)\n"
     "    return bool((v >= n).any())\n"
     "def f(x, r):\n"
     "    a = x.item()\n"
     "    b = int(torch.max(x))\n"
     "    m = torch.sum(x)\n"
     "    c = bool(torch.any(x))\n"
     "    d = float(m)\n"
     "    e = x.cpu().tolist()\n"
     "    torch.cuda.synchronize()\n"
     "    return a, b, c, d, e, int(umax(r.key))\n",
     [".item()", "int(tensor)", "bool(tensor)", "float(tensor)", ".cpu()",
      ".tolist()", ".synchronize()", "int(tensor)", "bool(tensor)"],
     "import numpy as np\n"
     "import torch\n"
     "from tpu_radix_join_torch.utils.hostsync import (host_fence,\n"
     "                                                  host_readback)\n"
     "def f(x, n, dev):\n"
     "    a = int(host_readback(x.max()))\n"
     "    b = host_readback(x).tolist()\n"
     "    c = int(narrow(torch.tensor(0xFFFFFFFF)))\n"
     "    d = int(np.uint64(n).sum())\n"
     "    host_fence(dev)\n"
     "    return a, b, c, d, int(len(b))\n"),
    ("recompile-hazard", f"{PKG}/foo.py",
     "import torch\n"
     "def f(xs, g, name):\n"
     "    for x in xs:\n"
     "        torch.compile(g)(x)\n"
     "    return library(f\"partition_{name}\")\n",
     ["compile-in-loop", "fstring-build-key"],
     "import torch\n"
     "def f(xs, g, name):\n"
     "    h = torch.compile(g)\n"
     "    for x in xs:\n"
     "        h(x)\n"
     "    return c_function(name, f\"rj_{name}\", [])\n"),
    ("lock-discipline", f"{PKG}/foo.py",
     _THREADED.format(body="self.count += 1"),
     ["Worker._loop:self.count"],
     _THREADED.format(body="with self._lock:\n"
                           "                self.count += 1")),
    ("lock-order", f"{PKG}/foo.py", _CYCLE,
     ["cycle:LeaseBoard._lock->MetricsSampler._lock"], _ORDERED),
]


@pytest.mark.parametrize("rule,rel,bad,keys,good", CASES,
                         ids=[c[0] for c in CASES])
def test_rule_fires_on_a_violation(tmp_path, rule, rel, bad, keys, good):
    found, res = _lint(tmp_path, rel, bad, [rule])
    assert sorted(f.key for f in found) == sorted(keys)
    assert all(f.record() == f"{rel}:{f.line}:{rule}" for f in found)
    assert res.exit_code() == 1


@pytest.mark.parametrize("rule,rel,bad,keys,good", CASES,
                         ids=[c[0] for c in CASES])
def test_rule_passes_the_sanctioned_spelling(tmp_path, rule, rel, bad, keys,
                                             good):
    found, _ = _lint(tmp_path, rel, good, [rule])
    assert found == []


def test_sync_point_hot_methods_only_in_hot_files(tmp_path):
    code = ("import torch\n"
            "def f(x):\n"
            "    torch.cuda.synchronize()\n"
            "    return x.cpu().numpy(), x.item()\n")
    found, _ = _lint(tmp_path, f"{PKG}/planner/cold.py", code,
                     ["sync-point"])
    assert [f.key for f in found] == [".item()"]     # everywhere
    found, _ = _lint(tmp_path, f"{PKG}/utils/hostsync.py", code,
                     ["sync-point"])
    assert found == []                               # the implementation


def test_sort_bypass_allows_the_switch_and_the_plain_versions(tmp_path):
    code = "import torch\ndef f(x):\n    return torch.sort(x)\n"
    for rel in (f"{PKG}/ops/sorting.py", f"{PKG}/ops/kernels/radix_sort.py"):
        found, _ = _lint(tmp_path, rel, code, ["sort-bypass"])
        assert found == []


def test_counter_tag_reports_dead_pins(tmp_path):
    _, res = _lint(tmp_path, f"{PKG}/foo.py", "x = 1\n", ["counter-tag"])
    dead = [f for f in res.findings
            if f.path == f"{PKG}/observability/regress.py"]
    assert any(f.key == "RTUPLES" for f in dead)


# ---------------------------------------------------------- inline waivers
def test_waiver_needs_a_reason(tmp_path):
    waived = _THREADED.format(
        body="self.count += 1  # lint: unguarded-ok(one-shot flag; "
             "readers join first)")
    found, _ = _lint(tmp_path, f"{PKG}/foo.py", waived, ["lock-discipline"])
    assert found == []
    bare = _THREADED.format(body="self.count += 1  # lint: unguarded-ok()")
    found, _ = _lint(tmp_path, f"{PKG}/foo.py", bare, ["lock-discipline"])
    assert len(found) == 1


def test_waiver_token_is_rule_specific(tmp_path):
    code = ("import torch\n"
            "def f(x):\n"
            "    return torch.sort(x)  # lint: sync-ok(wrong token)\n")
    found, _ = _lint(tmp_path, f"{PKG}/foo.py", code, ["sort-bypass"])
    assert len(found) == 1
    code = code.replace("sync-ok(wrong token)", "sort-ok(a fixture's keep)")
    found, _ = _lint(tmp_path, f"{PKG}/foo.py", code, ["sort-bypass"])
    assert found == []


# ---------------------------------------------------------------- baseline
def _baseline(tmp_path, entries):
    p = tmp_path / "LINT_BASELINE.json"
    p.write_text(json.dumps({"suppressions": entries}))
    return str(p)


_SORT = "import torch\ndef f(x):\n    return torch.argsort(x)\n"


def test_baseline_suppresses_and_reports_stale_entries(tmp_path):
    bl = _baseline(tmp_path, [
        {"rule": "sort-bypass", "path": f"{PKG}/foo.py",
         "key": "torch.argsort", "reason": "fixture keep"},
        {"rule": "sort-bypass", "path": f"{PKG}/gone.py",
         "key": "torch.sort", "reason": "the finding was fixed"}])
    found, res = _lint(tmp_path, f"{PKG}/foo.py", _SORT, ["sort-bypass"],
                       baseline=bl)
    assert found == [] and len(res.suppressed) == 1
    assert [e["path"] for e in res.stale] == [f"{PKG}/gone.py"]
    assert res.exit_code(strict=False) == 0
    assert res.exit_code(strict=True) == 1
    # a rule that did not run judges no entry stale
    _, res = _lint(tmp_path, f"{PKG}/foo.py", _SORT, ["sync-point"],
                   baseline=bl)
    assert res.stale == []


@pytest.mark.parametrize("entry", [
    {"rule": "sort-bypass", "path": f"{PKG}/foo.py", "key": "torch.argsort",
     "reason": "   "},
    {"rule": "sort-bypass", "path": f"{PKG}/foo.py", "key": "torch.argsort"},
    {"rule": "no-such-rule", "path": f"{PKG}/foo.py", "key": "x",
     "reason": "an unknown rule"}], ids=["blank", "reasonless", "unknown"])
def test_baseline_bad_entry_is_a_load_error(tmp_path, entry):
    bl = _baseline(tmp_path, [entry])
    with pytest.raises(LintError):
        _lint(tmp_path, f"{PKG}/foo.py", _SORT, ["sort-bypass"], baseline=bl)


def test_unknown_rule_id_is_a_lint_error(tmp_path):
    with pytest.raises(LintError):
        run_lint(str(tmp_path), rule_ids=["no-such-rule"], paths=[])


# ------------------------------------------------- parity with JAX's core
#: framework-neutral sources: thread-target writes, lock cycles, literal
#: failure classes (the JAX rules' spellings, no device calls)
PARITY = [
    ("lock-discipline", _THREADED.format(body="self.count += 1")),
    ("lock-discipline", _THREADED.format(
        body="self._step()") + "\n        def _step(self):\n"
                               "            self.count = 2\n"),
    ("lock-discipline", _THREADED.format(
        body="self.count = 1  # lint: unguarded-ok(joined before read)")),
    ("lock-order", _CYCLE),
    ("lock-order", _ORDERED),
    ("failure-class",
     "def f(g):\n"
     "    g(failure_class=\"oom\")\n"
     "    g(failure_class=\"rank_lost\")\n"
     "    d = {\"failure_class\": \"deadline_exceeded\"}\n"
     "    d[\"failure_class\"] = \"rank-lost\"\n"),
]


@pytest.mark.parametrize("rule,code", PARITY,
                         ids=[f"{r}-{i}" for i, (r, _) in enumerate(PARITY)])
def test_core_parity_with_jax(tmp_path, rule, code):
    got = []
    for runner in (run_lint, jcore.run_lint):
        found, res = _lint(tmp_path, "fixture.py", code, [rule],
                           runner=runner)
        got.append(([(f.rule, f.path, f.line, f.key) for f in found],
                    res.exit_code(), res.exit_code(strict=True)))
    assert got[0] == got[1]


# ------------------------------------------------------------ CLI contract
def test_cli_exit_codes(tmp_path, capsys):
    assert tlint.main(["--strict"]) == 0
    assert tlint.main(["--no-baseline", "--rule", "sort-bypass"]) == 1
    assert tlint.main(["--rule", "no-such-rule"]) == 2
    assert tlint.main(["--baseline", str(tmp_path / "missing.json")]) == 2
    assert tlint.main(["--list-rules"]) == 0
    rules = capsys.readouterr().out
    assert all(r in rules for r in ("sync-point", "lock-order",
                                    "recompile-hazard"))
    out = tmp_path / "lint.json"
    assert tlint.main(["--strict", "--json", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["lint_findings"] == 0 and data["stale_baseline"] == 0
    assert data["suppressed"] >= 1 and len(data["rules_run"]) == 7


# ------------------------------------------------------------- self-clean
def test_port_is_lint_clean():
    """Every rule over the port's tree (the package and chip_smoke.py),
    its baseline applied, strict: a new convention violation fails here
    with its path:line:rule record; every baseline entry has a reason."""
    bl = default_baseline(REPO_ROOT)
    res = run_lint(REPO_ROOT, baseline_path=bl)
    assert not res.findings, "\n".join(f.render() for f in res.findings)
    assert not res.stale, f"stale baseline suppressions: {res.stale}"
    with open(bl) as f:
        entries = json.load(f)["suppressions"]
    assert all(e["reason"].strip() for e in entries)
