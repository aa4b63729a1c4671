"""The port's lint layer: every rule has a case where it fires and one
where it stays quiet (the reference's 30 cases, each with its torch
counterpart), the suppression contract under the port's own marker
(justified allows suppress; unjustified and stale ones are findings; the
reference's marker is another one), churn-stable fingerprints and syntax
errors as findings. The three rules both packages share give the
reference's findings and fingerprints on the same source, and the port's
default roots lint clean against ``analysis/baseline_torch.json``."""
import json
import textwrap

from repro.analysis.lint import LintEngine as RefEngine
from repro_torch.analysis import check
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.lint import LintEngine, parse_suppressions
from repro_torch.analysis.rules import SHARED_RULES
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def lint(src: str, path: str = "fix.py"):
    return LintEngine().lint_source(textwrap.dedent(src), path)


def rules_of(findings):
    return sorted(f.rule for f in findings)


# ---------------------------------------------------------------- RNG --
def test_ambient_np_random_fires():
    out = lint("""
        import numpy as np
        def f():
            return np.random.rand(3)
    """)
    assert "ambient-np-random" in rules_of(out)


def test_generator_api_is_quiet():
    out = lint("""
        import numpy as np
        import torch
        def f():
            rng = np.random.default_rng(0)
            g = torch.Generator().manual_seed(0)
            return rng.normal(size=3), torch.randn(3, generator=g)
    """)
    assert out == []


def test_unseeded_default_rng_fires():
    out = lint("""
        import numpy as np
        rng = np.random.default_rng()
    """)
    assert rules_of(out) == ["unseeded-default-rng"]


def test_seeded_default_rng_quiet():
    assert lint("""
        import numpy as np
        rng = np.random.default_rng(1234)
    """) == []


def test_import_alias_resolution():
    # aliases resolve: numpy.random through npr, torch.nn.functional as F
    out = lint("""
        from numpy import random as npr
        import torch.nn.functional as F
        x = npr.rand(3)
        y = F.dropout(x, 0.5)
    """)
    assert rules_of(out) == ["ambient-np-random", "ambient-torch-random"]


def test_ambient_torch_random_fires():
    out = lint("""
        import torch
        from torch import randn
        a = torch.rand(3)
        b = randn(2, device="cpu")
        c = torch.empty(4).normal_()
        d = torch.randint(0, 5, (3,))
    """)
    assert rules_of(out) == ["ambient-torch-random"] * 4


def test_manual_seed_fires_in_package_code_only():
    src = """
        import torch
        torch.manual_seed(0)
    """
    assert rules_of(lint(src, "src/repro_torch/x.py")) == [
        "ambient-torch-random"]
    assert lint(src, "tests/test_torch_x.py") == []


# ---------------------------------------------------------- PRNG keys --
def test_key_reuse_fires():
    out = lint("""
        from repro_torch.core import prng
        def f():
            key = prng.prng_key(0)
            a = prng.normal(key, (3,))
            b = prng.normal(key, (3,))
            return a, b
    """)
    assert "prng-key-reuse" in rules_of(out)


def test_split_then_use_quiet():
    assert lint("""
        from ..core import prng
        def f():
            key = prng.prng_key(0)
            k1, k2 = prng.split(key)
            a = prng.normal(k1, (3,))
            b = prng.uniform(k2, (3,))
            return a, b
    """) == []


def test_reassigned_key_quiet():
    assert lint("""
        from repro_torch.core import prng
        def f(key):
            a = prng.normal(key, (3,))
            key = prng.fold_in(key, 1)
            b = prng.normal(key, (3,))
            key = prng.fold_in(key, 2)
            key = prng.split(key)[0]
            c = prng.bernoulli(key, 0.5, (3,))
            return a, b, c
    """) == []


def test_consume_in_loop_fires():
    out = lint("""
        from repro_torch.core import prng
        def f(key):
            out = []
            for i in range(4):
                out.append(prng.randint(key, (3,), 0, 9))
            return out
    """)
    assert "prng-key-reuse" in rules_of(out)


def test_loop_with_per_iteration_split_quiet():
    assert lint("""
        from repro_torch.core import prng
        def f(key):
            out = []
            for i in range(4):
                key, sub = prng.split(key)
                out.append(prng.normal(sub, (3,)))
            return out
    """) == []


def test_loop_over_split_keys_quiet():
    assert lint("""
        from repro_torch.core import prng
        def f(key):
            return [prng.normal(k, (3,)) for k in prng.split(key, 4)]
    """) == []


# ------------------------------------- host syncs in a captured window --
def test_host_sync_inside_window_fires():
    out = lint("""
        import numpy as np
        class T:
            def _round_impl(self, state, x):
                return np.asarray(x) + 1
    """)
    assert "host-sync-in-window" in rules_of(out)


def test_item_inside_graph_body_fires():
    out = lint("""
        import torch
        def body(carry, x):
            return carry + x.item()
        def capture(g, carry, x):
            with torch.cuda.graph(g):
                out = body(carry, x)
            return out
    """)
    assert "host-sync-in-window" in rules_of(out)


def test_float_on_param_inside_window_fires():
    out = lint("""
        class T:
            def _window(self, state, ins, use_fused):
                n = float(ins["idx"].shape[0])
                return float(state.kappa) * n
    """)
    assert rules_of(out) == ["host-sync-in-window"]


def test_host_sync_outside_window_quiet():
    assert lint("""
        import numpy as np
        def metrics(x):
            return float(np.asarray(x).mean()), x.cpu().tolist()
    """) == []


def test_reachability_through_called_methods():
    # _window -> self._step -> _helper (a bare module function): the
    # helper's .tolist() runs inside the window
    out = lint("""
        def _helper(x):
            return x.tolist()
        class T:
            def _step(self, x):
                return _helper(x)
            def _window(self, state, ins, use_fused):
                return self._step(ins["idx"])
            def report(self, x):
                return x.tolist()
    """)
    assert rules_of(out) == ["host-sync-in-window"]
    assert out[0].line == 3


# ------------------------------------------------------ traced branch --
def test_traced_branch_fires():
    out = lint("""
        import torch
        class T:
            def _rr_step(self, state, mask):
                if torch.any(mask > 0):
                    state = state + 1
                while mask.sum() > 0:
                    mask = mask - 1
                return state
    """)
    assert rules_of(out) == ["traced-branch", "traced-branch"]


def test_python_branch_outside_window_quiet():
    assert lint("""
        import torch
        def pick(n, t):
            if n > 0 and bool(t.any()):
                return 1
            return 2
        class T:
            def _sim_step(self, state, iw=None, *, use_fused=False):
                if iw is None or use_fused or state.ndim > 1:
                    return state
                if torch.cuda.is_available():
                    return state
                return iw * state
    """) == []


# ------------------------------------------------------ debug leftovers --
def test_leftover_debug_fires():
    out = lint("""
        import pdb
        def f(x):
            breakpoint()
            pdb.set_trace()
            print(x)
            return x
        class T:
            def _window(self, state, ins, use_fused):
                print(state)
                return state
    """)
    assert rules_of(out) == ["debug-leftover"] * 3
    assert [f.line for f in out] == [4, 5, 10]


def test_mutable_default_fires():
    out = lint("""
        def f(items=[]):
            return items
    """)
    assert rules_of(out) == ["mutable-default"]


def test_immutable_default_quiet():
    assert lint("""
        def f(items=(), other=None):
            return items, other
    """) == []


# ------------------------------------------------------- suppressions --
def test_justified_allow_suppresses():
    assert lint("""
        import numpy as np
        x = np.random.rand(3)  # repro_torch: allow(ambient-np-random) -- fixture
    """) == []


def test_allow_on_line_above():
    assert lint("""
        import torch
        # repro_torch: allow(ambient-torch-random) -- fixture
        x = torch.rand(3)
    """) == []


def test_unjustified_allow_is_a_finding():
    out = lint("""
        import numpy as np
        x = np.random.rand(3)  # repro_torch: allow(ambient-np-random)
    """)
    assert rules_of(out) == ["unjustified-suppression"]


def test_stale_allow_is_a_finding():
    out = lint("""
        x = 1  # repro_torch: allow(ambient-np-random) -- nothing here
    """)
    assert rules_of(out) == ["unused-suppression"]


def test_file_wide_allow():
    assert lint("""
        # repro_torch: allow-file(ambient-torch-random) -- generator fixture file
        import torch
        a = torch.rand(3)
        b = torch.randn(3)
    """) == []


def test_docstring_allow_is_inert():
    # allow() syntax quoted in a docstring must not register
    out = lint('''
        def f():
            """Example: # repro_torch: allow(ambient-np-random) -- doc"""
            return 1
    ''')
    assert out == []


def test_suppressions_parse_lines():
    sups = parse_suppressions("p.py",
                              "x = 1\n# repro_torch: allow(a-b) -- y\n")
    assert len(sups) == 1 and sups[0].line == 2 and sups[0].justified


def test_markers_belong_to_their_package():
    """The reference's marker suppresses nothing here (and is no stale
    allow either), and the port's nothing in the reference's engine."""
    src = textwrap.dedent("""
        import numpy as np
        x = np.random.rand(3)  # repro: allow(ambient-np-random) -- ref
        z = 1
        y = np.random.rand(3)  # repro_torch: allow(ambient-np-random) -- port
    """)
    port = LintEngine().lint_source(src, "fix.py")
    ref = RefEngine().lint_source(src, "fix.py")
    assert [(f.rule, f.line) for f in port] == [("ambient-np-random", 3)]
    assert [(f.rule, f.line) for f in ref] == [("ambient-np-random", 5)]


# -------------------------------------------------------- fingerprint --
def test_fingerprint_survives_line_churn():
    a = Finding(rule="r", path="p.py", line=10, col=0, message="m",
                snippet="x = torch.rand(3)")
    b = Finding(rule="r", path="p.py", line=99, col=4, message="m",
                snippet="x  =  torch.rand(3)")
    assert a.fingerprint == b.fingerprint
    c = Finding(rule="r2", path="p.py", line=10, col=0, message="m",
                snippet="x = torch.rand(3)")
    assert a.fingerprint != c.fingerprint


def test_syntax_error_is_reported_not_raised():
    out = LintEngine().lint_source("def broken(:\n", "bad.py")
    assert rules_of(out) == ["syntax-error"]


# ------------------------------------------------ against the reference --
SHARED_FIXTURE = """
import collections
import numpy as np
from numpy import random as npr

def draw(n, cache={}, seen=[], *, by=collections.defaultdict(list)):
    a = np.random.rand(n)
    b = npr.normal(size=n)
    g = np.random.default_rng()
    h = np.random.default_rng(None)
    ok = np.random.default_rng(7).normal(size=n)
    return a, b, g, h, ok, np.random.Generator(np.random.PCG64(1))

def quiet(items=(), other=None):
    return np.random.default_rng(3), items, other
"""


def test_shared_rules_give_the_references_findings():
    """On the same source the shared rules give the reference's findings,
    messages and fingerprints, one for one."""
    port = [f for f in LintEngine().lint_source(SHARED_FIXTURE, "src/m.py")
            if f.rule in SHARED_RULES]
    ref = [f for f in RefEngine().lint_source(SHARED_FIXTURE, "src/m.py")
           if f.rule in SHARED_RULES]
    assert len(port) == 7
    assert [f.to_dict() for f in port] == [f.to_dict() for f in ref]


def test_shared_rules_match_the_reference_on_the_port_tree():
    """Over the port's whole default roots, the shared rules' findings
    (none today) are the reference engine's on the same files."""
    files = list(LintEngine(root=check.REPO_ROOT).iter_files(
        check.expand(check.DEFAULT_PATHS)))
    assert len(files) > 100
    for f in files:
        rel = f.resolve().relative_to(check.REPO_ROOT).as_posix()
        src = f.read_text()
        port = [x.fingerprint for x in LintEngine().lint_source(src, rel)
                if x.rule in SHARED_RULES]
        ref = [x.fingerprint for x in RefEngine().lint_source(src, rel)
               if x.rule in SHARED_RULES]
        assert port == ref, rel


def test_default_roots_lint_clean_against_the_baseline():
    baseline = json.loads(check.BASELINE_PATH.read_text())
    assert baseline["findings"] == []
    paths = check.expand(check.DEFAULT_PATHS)
    new, baselined, _ = check.run_lint(
        paths, check._load_baseline(check.BASELINE_PATH))
    assert [f.render() for f in new] == [] and baselined == 0
    assert check.main(["--skip-ruff", "--skip-audit", "--skip-budget",
                       "--json"]) == 0


def test_reference_package_is_never_linted():
    files = LintEngine(root=check.REPO_ROOT).iter_files(
        [check.REPO_ROOT / "src"])
    rels = {f.resolve().relative_to(check.REPO_ROOT).as_posix()
            for f in files}
    assert any(r.startswith("src/repro_torch/") for r in rels)
    assert not any(r.startswith("src/repro/") for r in rels)
