"""The port's AST lint rules (the JAX package's ``analysis/rules.py``).

Every rule guards an invariant the tests pin only by example: seeded
draws everywhere (every draw from a threefry key of ``core/prng.py``, a
seeded numpy ``Generator`` on the host), no host sync inside a captured
window (a CUDA graph cannot hold one: a capture fails or, worse, bakes a
value in), and no leftover debugging.

Three rules keep the reference's names and meaning and give its findings
on the same source: ``ambient-np-random``, ``unseeded-default-rng``,
``mutable-default``. The others are the counterparts of its JAX rules:

* ``ambient-torch-random`` (for its ``jax.random`` discipline): a torch
  sampler with no ``generator=``, or ``torch.manual_seed`` in package code.
* ``prng-key-reuse``: one threefry key consumed twice without a split or
  a fold-in between, over ``core/prng.py``'s API.
* ``host-sync-in-window`` (``host-sync-in-jit``) and ``traced-branch``
  inside the code a captured window reaches: the functions called in a
  ``with torch.cuda.graph(...)`` body, and every method named
  ``_window``, ``_round_impl``, ``_rr_step`` or ``_sim_step`` (a window's
  rounds), with what they call within the module.
* ``debug-leftover`` (``jax-debug``): ``breakpoint()``, ``pdb.set_trace()``
  anywhere, a ``print`` in that reachable set.

A rule sees one :class:`ModuleContext` and yields :class:`Finding`s; the
engine (``lint.py``) applies the ``# repro_torch: allow(<rule>)``
suppressions afterwards.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator

from .findings import Finding

#: methods that run a captured window's rounds (the trainers' names)
WINDOW_METHODS = {"_window", "_round_impl", "_rr_step", "_sim_step"}

#: the call whose ``with`` body is captured into a CUDA graph
_GRAPH_CONTEXTS = {"torch.cuda.graph"}

#: numpy.random attributes that are seeded-constructor machinery, not
#: ambient global-state sampling
_NP_RANDOM_OK = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator",
    "PCG64", "PCG64DXSM", "Philox", "MT19937", "SFC64",
}

#: torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = {
    "torch.rand", "torch.rand_like", "torch.randn", "torch.randn_like",
    "torch.randint", "torch.randint_like", "torch.randperm",
    "torch.normal", "torch.bernoulli", "torch.multinomial",
    "torch.poisson", "torch.dropout", "torch.nn.functional.dropout",
    "torch.nn.functional.dropout1d", "torch.nn.functional.dropout2d",
    "torch.nn.functional.dropout3d", "torch.nn.functional.alpha_dropout",
    "torch.nn.init.uniform_", "torch.nn.init.normal_",
    "torch.nn.init.trunc_normal_", "torch.nn.init.xavier_uniform_",
    "torch.nn.init.xavier_normal_", "torch.nn.init.kaiming_uniform_",
    "torch.nn.init.kaiming_normal_", "torch.nn.init.orthogonal_",
    "torch.nn.init.sparse_",
}
#: in-place tensor samplers (a method on any tensor)
_TENSOR_SAMPLERS = {"normal_", "uniform_", "bernoulli_", "random_",
                    "exponential_", "geometric_", "cauchy_", "log_normal_"}
#: seeding the global generators
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.cuda.seed",
                 "torch.cuda.seed_all", "torch.random.manual_seed",
                 "torch.random.seed"}

#: core/prng.py's key API: the calls that consume their first argument's
#: key (``split`` retires it; ``fold_in`` and ``prng_key`` derive)
_KEY_CONSUMING = {"random_bits", "uniform", "normal", "normal_blocks",
                  "bernoulli", "randint", "draws"}
_PRNG_CALL = re.compile(r"(?:^|\.)prng\.(?P<fn>\w+)$")

#: tensor methods that copy to the host or wait for the device
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_SYNC_CALLS = {"torch.cuda.synchronize", "numpy.asarray", "numpy.array"}
_CASTS = {"float", "int", "bool", "complex"}
#: attribute names that are host metadata of a tensor, not its values
_METADATA = {"shape", "ndim", "dtype", "device", "size", "numel", "dim",
             "is_cuda", "layout", "requires_grad", "names"}
#: tensor methods whose result a Python branch would read on the host
_REDUCTIONS = {"any", "all", "item", "sum", "max", "min", "mean", "eq",
               "ne", "gt", "lt", "ge", "le", "equal", "allclose", "isnan",
               "isinf", "isfinite", "nonzero", "count_nonzero", "norm",
               "prod", "amax", "amin", "argmax", "argmin"}


def _attr_chain(node: ast.AST) -> str | None:
    """Dotted source text of a Name/Attribute chain ("torch.cuda.graph")."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _root(node: ast.AST) -> tuple[str | None, set[str]]:
    """The Name at the root of an attribute/subscript/call chain, and the
    attribute names met on the way down."""
    attrs: set[str] = set()
    while True:
        if isinstance(node, ast.Attribute):
            attrs.add(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            return node.id, attrs
        else:
            return None, attrs


class ModuleContext:
    """Everything the rules need to know about one parsed module."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.aliases = self._collect_aliases(tree)
        self._functions = [n for n in ast.walk(tree)
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
        self.window_reachable = self._window_reachable()

    @property
    def is_package(self) -> bool:
        """Whether the module is package code (not a test or script)."""
        return self.path.startswith("src/")

    # -- alias map ----------------------------------------------------
    @staticmethod
    def _collect_aliases(tree: ast.Module) -> dict[str, str]:
        """local name -> canonical dotted module/attribute path."""
        aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")
            elif isinstance(node, ast.ImportFrom):   # from . import prng
                for a in node.names:
                    aliases[a.asname or a.name] = a.name
        return aliases

    def resolve(self, node: ast.AST) -> str | None:
        """Canonical dotted path of a call target / attribute chain, with
        the leading segment resolved through the import aliases
        ("F.dropout" -> "torch.nn.functional.dropout")."""
        chain = _attr_chain(node)
        if chain is None:
            return None
        head, _, rest = chain.partition(".")
        head = self.aliases.get(head, head)
        return f"{head}.{rest}" if rest else head

    # -- captured-window reachability ------------------------------------
    def _window_reachable(self) -> set[ast.AST]:
        """Function nodes a captured window runs: the window methods
        (:data:`WINDOW_METHODS`), the functions called in a ``with
        torch.cuda.graph(...)`` body, and (transitively) what they call
        within this module by bare name or ``self.``/``cls.``. Nested
        defs are covered by walking the reachable subtrees."""
        by_name: dict[str, list[ast.AST]] = {}
        for fn in self._functions:
            by_name.setdefault(fn.name, []).append(fn)

        entries: set[ast.AST] = {fn for fn in self._functions
                                 if fn.name in WINDOW_METHODS}
        for node in ast.walk(self.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(isinstance(item.context_expr, ast.Call)
                       and self.resolve(item.context_expr.func)
                       in _GRAPH_CONTEXTS for item in node.items):
                continue
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        name = (_attr_chain(sub.func) or "").rsplit(
                            ".", maxsplit=1)[-1]
                        entries.update(by_name.get(name, []))

        reachable = set(entries)
        frontier = list(entries)
        while frontier:
            fn = frontier.pop()
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                chain = _attr_chain(node.func) or ""
                name = chain.rsplit(".", maxsplit=1)[-1]
                if chain in (name, f"self.{name}", f"cls.{name}"):
                    for cand in by_name.get(name, []):
                        if cand not in reachable:
                            reachable.add(cand)
                            frontier.append(cand)
        return reachable

    # -- helpers -------------------------------------------------------
    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        snippet = (self.lines[line - 1].strip()
                   if 0 < line <= len(self.lines) else "")
        return Finding(rule=rule, path=self.path, line=line,
                       col=getattr(node, "col_offset", 0),
                       message=message, snippet=snippet)

    def reachable_subtrees(self) -> Iterator[ast.AST]:
        """Window-reachable function nodes, outermost first, with nested
        reachable functions pruned (their subtree is already covered)."""
        covered: set[ast.AST] = set()
        for fn in sorted(self.window_reachable,
                         key=lambda n: (n.lineno, n.col_offset)):
            if fn in covered:
                continue
            for sub in ast.walk(fn):
                if sub is not fn and sub in self.window_reachable:
                    covered.add(sub)
            yield fn


def _subtree_param_names(fn) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            a = node.args
            for arg in (list(a.posonlyargs) + list(a.args)
                        + list(a.kwonlyargs)):
                names.add(arg.arg)
    names.discard("self")
    names.discard("cls")
    return names


def _reads_tensor(node: ast.AST, params: set[str]) -> bool:
    """Whether ``node`` reads a value rooted at one of ``params`` (taken
    for device tensors), not its host metadata (shape, dtype, …)."""
    root, attrs = _root(node)
    return root in params and not attrs & _METADATA


# ---------------------------------------------------------------------------
# Rules.
# ---------------------------------------------------------------------------

class Rule:
    name: str = ""
    description: str = ""

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        raise NotImplementedError  # pragma: no cover - interface


class AmbientNpRandomRule(Rule):
    """Ambient ``np.random.*`` sampling mutates hidden global state: one
    call anywhere desynchronizes every seeded trajectory pin. Only seeded
    ``Generator`` streams are allowed."""

    name = "ambient-np-random"
    description = ("ambient numpy.random global-state call; use a "
                   "seeded np.random.default_rng(seed) Generator")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = ctx.resolve(node.func) or ""
            if not target.startswith("numpy.random."):
                continue
            attr = target.removeprefix("numpy.random.").split(".")[0]
            if attr not in _NP_RANDOM_OK:
                yield ctx.finding(
                    self.name, node,
                    f"ambient numpy.random.{attr}() uses hidden global "
                    "RNG state; draw from a seeded default_rng stream")


class UnseededDefaultRngRule(Rule):
    """``default_rng()`` without a seed draws OS entropy: every run takes
    a different trajectory."""

    name = "unseeded-default-rng"
    description = "np.random.default_rng() without an explicit seed"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = ctx.resolve(node.func) or ""
            if not target.endswith("random.default_rng"):
                continue
            unseeded = (not node.args and not node.keywords) or (
                len(node.args) == 1 and isinstance(node.args[0],
                                                   ast.Constant)
                and node.args[0].value is None)
            if unseeded:
                yield ctx.finding(
                    self.name, node,
                    "default_rng() without a seed is entropy-seeded; "
                    "pass an explicit seed (or derived SeedSequence)")


class AmbientTorchRandomRule(Rule):
    """A torch sampler without ``generator=`` draws from the process's
    global generator: its values depend on every draw made before it, in
    any module, and the port's draws follow the reference's threefry key
    tree (``core/prng.py``) instead. Seeding that global generator in
    package code (``torch.manual_seed``) hides the dependence."""

    name = "ambient-torch-random"
    description = ("torch sampler without generator=, or the global "
                   "generator seeded in package code")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            target = ctx.resolve(node.func) or ""
            has_gen = any(k.arg == "generator" for k in node.keywords)
            if target in _TORCH_SAMPLERS and not has_gen:
                yield ctx.finding(
                    self.name, node,
                    f"{target}() draws from torch's global generator; "
                    "draw from a threefry key (core/prng.py) or pass a "
                    "seeded generator=")
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TENSOR_SAMPLERS
                    and target not in _TORCH_SAMPLERS and not has_gen):
                yield ctx.finding(
                    self.name, node,
                    f".{node.func.attr}() draws from torch's global "
                    "generator; pass a seeded generator=")
            elif target in _GLOBAL_SEEDS and ctx.is_package:
                yield ctx.finding(
                    self.name, node,
                    f"{target}() seeds the global generator from package "
                    "code; draw from a threefry key instead")


class PrngKeyReuseRule(Rule):
    """A threefry key consumed twice yields the same bits twice: two
    samplers see correlated draws. Straight-line double consumption of
    one key name (without re-binding through ``prng.split`` or
    ``prng.fold_in``) is flagged, and a key consumed every iteration of a
    loop that never re-binds it."""

    name = "prng-key-reuse"
    description = ("core/prng.py key consumed twice without split/"
                   "fold_in between uses")

    def _prng_fn(self, ctx: ModuleContext, node: ast.Call) -> str | None:
        m = _PRNG_CALL.search(ctx.resolve(node.func) or "")
        return m.group("fn") if m else None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in ctx._functions:
            yield from self._check_fn(ctx, fn)

    def _check_fn(self, ctx: ModuleContext, fn) -> Iterator[Finding]:
        # Linear event stream in source order; loop bodies get their own
        # analysis (per-iteration derivation is the common pattern there).
        events: list[tuple[int, int, str, str]] = []

        def visit(node, in_loop: bool):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return  # nested scopes analyzed on their own
            if isinstance(node, (ast.For, ast.While)):
                assigned: set[str] = set()
                consumed: list[tuple[int, int, str]] = []

                def scan_loop(n):
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                        return
                    for tgt, _ in _assignment_targets(n):
                        assigned.add(tgt.id)
                    if isinstance(n, ast.Call):
                        attr = self._prng_fn(ctx, n)
                        if (attr in _KEY_CONSUMING and n.args
                                and isinstance(n.args[0], ast.Name)):
                            consumed.append((n.lineno, n.col_offset,
                                             n.args[0].id))
                    for child in ast.iter_child_nodes(n):
                        scan_loop(child)

                if isinstance(node, ast.For):
                    for sub in ast.walk(node.target):
                        if isinstance(sub, ast.Name):
                            assigned.add(sub.id)
                for child in node.body + getattr(node, "orelse", []):
                    scan_loop(child)
                for line, col, name in consumed:
                    if name not in assigned:
                        events.append((line, col, "loop-consume", name))
                return
            if isinstance(node, ast.Call):
                attr = self._prng_fn(ctx, node)
                if (attr is not None and node.args
                        and isinstance(node.args[0], ast.Name)):
                    if attr in _KEY_CONSUMING and not in_loop:
                        events.append((node.lineno, node.col_offset,
                                       "consume", node.args[0].id))
                    elif attr == "split":
                        events.append((node.lineno, node.col_offset,
                                       "retire", node.args[0].id))
            for tgt_node, kind in _assignment_targets(node):
                events.append((node.end_lineno, node.end_col_offset,
                               kind, tgt_node.id))
            for child in ast.iter_child_nodes(node):
                visit(child, in_loop)

        for stmt in fn.body:
            visit(stmt, False)

        events.sort(key=lambda e: (e[0], e[1]))
        used: dict[str, str] = {}   # name -> how it was last consumed
        for line, col, kind, name in events:
            snippet = (ctx.lines[line - 1].strip()
                       if 0 < line <= len(ctx.lines) else "")
            if kind == "assign":
                used.pop(name, None)
            elif kind == "loop-consume":
                yield Finding(
                    rule=self.name, path=ctx.path, line=line, col=col,
                    snippet=snippet,
                    message=(f"key {name!r} consumed every loop iteration "
                             "without re-binding; prng.split or "
                             "prng.fold_in per iteration"))
                used[name] = kind
            elif kind in ("consume", "retire"):
                if name in used:
                    yield Finding(
                        rule=self.name, path=ctx.path, line=line,
                        col=col, snippet=snippet,
                        message=(f"key {name!r} already consumed "
                                 f"({used[name]}); prng.split or "
                                 "prng.fold_in before reusing it"))
                used[name] = kind


def _assignment_targets(node):
    """(Name node, "assign") pairs this statement (re)binds. The event
    sorts at the statement's end: ``key = prng.split(key)[0]`` consumes
    the old key before it binds the new one."""
    out = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                           ast.NamedExpr)):
        targets = [node.target]
    else:
        return out
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                out.append((sub, "assign"))
    return out


class HostSyncInWindowRule(Rule):
    """A host sync inside code a captured window runs either fails the
    capture (a copy to the host, a stream or device wait) or runs once at
    capture time and bakes that value into every replay. ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.synchronize()``,
    ``torch.cuda.synchronize`` and ``np.asarray`` are always flagged;
    ``float``/``int``/``bool`` when their argument reads a parameter of
    the reachable function (not its shape or dtype)."""

    name = "host-sync-in-window"
    description = ("host-synchronizing call inside a function a captured "
                   "window reaches")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in ctx.reachable_subtrees():
            params = _subtree_param_names(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                target = ctx.resolve(node.func) or ""
                if target in _SYNC_CALLS:
                    yield ctx.finding(
                        self.name, node,
                        f"{target}() waits for or copies from the device "
                        "inside a captured window")
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _SYNC_METHODS
                        and not node.args):
                    yield ctx.finding(
                        self.name, node,
                        f".{node.func.attr}() waits for or copies from "
                        "the device inside a captured window")
                elif (target in _CASTS and len(node.args) == 1
                        and _reads_tensor(node.args[0], params)):
                    yield ctx.finding(
                        self.name, node,
                        f"{target}() of a device value inside a captured "
                        "window reads it on the host; keep it a tensor")


class TracedBranchRule(Rule):
    """A Python ``if``/``while`` on a tensor is an implicit host sync: an
    error under capture, and outside it a branch fixed at capture time.
    Flagged: branch conditions that compute on torch values (a ``torch.*``
    call, or a reduction method of a parameter's value) inside the code a
    captured window reaches; flags and ``is None`` tests stay legal."""

    name = "traced-branch"
    description = ("Python branch on a tensor inside a function a "
                   "captured window reaches; use torch.where")

    _HOST_PREDICATES = re.compile(
        r"^torch\.(is_\w+|cuda\.\w+|jit\.\w+|compiler\.\w+|"
        r"are_deterministic_algorithms_enabled|get_default_dtype)$")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in ctx.reachable_subtrees():
            params = _subtree_param_names(fn)
            for node in ast.walk(fn):
                if not isinstance(node, (ast.If, ast.While)):
                    continue
                if self._is_tensor_expr(ctx, node.test, params):
                    kw = "while" if isinstance(node, ast.While) else "if"
                    yield ctx.finding(
                        self.name, node,
                        f"`{kw}` on a tensor syncs with the device; use "
                        "torch.where (or decide it on the host before "
                        "the window)")

    def _is_tensor_expr(self, ctx, test: ast.AST, params: set[str]) -> bool:
        for node in ast.walk(test):
            if not isinstance(node, ast.Call):
                continue
            target = ctx.resolve(node.func) or ""
            if (target.startswith("torch.")
                    and not self._HOST_PREDICATES.match(target)):
                return True
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _REDUCTIONS
                    and _reads_tensor(node.func.value, params)):
                return True
        return False


class DebugLeftoverRule(Rule):
    """``breakpoint()`` and ``pdb.set_trace()`` stop any run; a ``print``
    in a captured window runs at capture time only and syncs whatever it
    formats. Debug-only: never committed."""

    name = "debug-leftover"
    description = "leftover breakpoint/pdb, or a print in a captured window"

    _STOPS = {"breakpoint", "pdb.set_trace", "ipdb.set_trace",
              "pdb.post_mortem"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and (ctx.resolve(node.func) or "") in self._STOPS):
                yield ctx.finding(
                    self.name, node,
                    f"{ctx.resolve(node.func)}() left in; remove it")
        for fn in ctx.reachable_subtrees():
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Name)
                        and node.func.id == "print"):
                    yield ctx.finding(
                        self.name, node,
                        "print() inside a captured window runs at capture "
                        "time only; remove it")


class MutableDefaultRule(Rule):
    """A mutable default argument is one shared object across calls:
    state leaks between rounds and trainers."""

    name = "mutable-default"
    description = "mutable default argument value"

    _MUTABLE_CALLS = {"list", "dict", "set", "bytearray",
                      "collections.defaultdict", "defaultdict"}

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for fn in ctx._functions:
            args = fn.args
            for default in list(args.defaults) + [
                    d for d in args.kw_defaults if d is not None]:
                if self._is_mutable(ctx, default):
                    yield ctx.finding(
                        self.name, default,
                        f"mutable default in {fn.name}(); use None and "
                        "construct inside the body")

    def _is_mutable(self, ctx: ModuleContext, node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            return True
        if isinstance(node, ast.Call):
            return (ctx.resolve(node.func) or "") in self._MUTABLE_CALLS
        return False


ALL_RULES: tuple[Rule, ...] = (
    AmbientNpRandomRule(),
    UnseededDefaultRngRule(),
    AmbientTorchRandomRule(),
    PrngKeyReuseRule(),
    HostSyncInWindowRule(),
    TracedBranchRule(),
    DebugLeftoverRule(),
    MutableDefaultRule(),
)

#: the rules whose meaning the reference's rules of the same name share
SHARED_RULES = ("ambient-np-random", "unseeded-default-rng",
                "mutable-default")

RULES_BY_NAME = {r.name: r for r in ALL_RULES}
