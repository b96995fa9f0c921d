"""Analyzer core: file contexts, the rule registry, suppressions (the
port's copy of ``photon_ml_tpu/lint/core.py``).

Everything here is stdlib-only (``ast`` + ``tokenize``) — the analyzer
must run in any environment the package runs in, including the minimal
CI container, without importing torch or the package under analysis.
The reference's per-scope jax-value taint is a torch-tensor taint here
(what PL001 reads), and the SPMD pass's ``# photon: sharding(...)``
grammar is not ported (its rules check ``shard_map`` programs).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import (
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

# -- violations and the rule registry ----------------------------------------


@dataclass
class Violation:
    rule: str  # "PL001"
    slug: str  # "hidden-host-sync"
    path: str  # normalized (posix, relative when possible)
    line: int
    col: int
    message: str
    snippet: str = ""  # stripped source line, the baseline matching key
    # The allow-site audit emits violations AT suppression comments; those
    # must not be swallowed by the very comment they audit.
    suppressable: bool = True

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "slug": self.slug,
            "file": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
        }


@dataclass
class Rule:
    id: str
    slug: str
    doc: str
    check: Callable[["FileContext"], Iterable[Violation]]


@dataclass
class PackageRule:
    """A rule that needs the WHOLE analyzed file set at once — the
    concurrency pass (PL008-PL010) builds per-class guard maps and a
    cross-module lock-acquisition graph, and the determinism pass
    (PL015-PL018) the wire-message inventory; neither exists at
    single-file granularity. ``group`` names the pass so the CLI can opt
    out of one without the other (--no-concurrency /
    --no-determinism)."""

    id: str
    slug: str
    doc: str
    check: Callable[["PackageContext"], Iterable[Violation]]
    group: str = "concurrency"


RULES: Dict[str, Rule] = {}
PACKAGE_RULES: Dict[str, PackageRule] = {}


def register(rule: Rule) -> Rule:
    RULES[rule.id] = rule
    return rule


def register_package(rule: PackageRule) -> PackageRule:
    PACKAGE_RULES[rule.id] = rule
    return rule


def all_rules():
    """Every registered rule (file-scoped + package-scoped), by id."""
    _load_rules()
    out: Dict[str, object] = {}
    out.update(RULES)
    out.update(PACKAGE_RULES)
    return out


def _load_rules() -> None:
    """Import the rule modules (each registers itself on import)."""
    if not RULES:
        import photon_ml_tpu_torch.lint.rules  # noqa: F401


# -- suppression comments ----------------------------------------------------

_ALLOW_RE = re.compile(r"#\s*photon:\s*allow\(\s*([A-Za-z0-9_\-,\s]*?)\s*\)")

# The guard-discipline declaration (concurrency pass, PL008):
#   self._flag = False  # photon: guarded-by(_lock)
# declares that every access to ``self._flag`` outside __init__ must
# hold ``self._lock``. The special token ``atomic`` declares a
# single-writer atomic-publish discipline instead: plain reference
# assignments only (no ``+=``, no in-place mutation), reads allowed
# anywhere. Annotations are DECLARATIONS the analyzer enforces, not
# suppressions — a violated declaration is a violation.
_GUARDED_RE = re.compile(
    r"#\s*photon:\s*guarded-by\(\s*([A-Za-z_][A-Za-z0-9_]*)\s*\)"
)

# The entropy declaration (determinism pass, PL016):
#   def snapshot(self):  # photon: entropy(live wall-clock timestamp)
#   _PROC_NONCE = ...    # photon: entropy(per-boot trace-id nonce)
# on the def line of a function (or on a module-level statement)
# declares that ambient entropy — wall clocks, pids, uuids, hash
# randomization, object identity — reaching an artifact, digest, cache
# key or wire payload in that scope is INTENTIONAL, and names why.
# Like guarded-by, this is an enforced claim, never a
# suppression: a declaration whose scope mints no entropy that reaches
# a sink is itself a violation (stale declaration).
_ENTROPY_RE = re.compile(r"#\s*photon:\s*entropy\(([^)]*)\)")


@dataclass
class AllowSite:
    line: int  # line the comment is ON
    applies_to: int  # line the suppression covers
    rules: Set[str]  # tokens as written (ids and/or slugs)
    path: str = ""
    # set by the PL001 audit for hidden-host-sync sites: does the
    # enclosing scope feed the counted seam / serial switch?
    seam_ok: Optional[bool] = None

    def to_dict(self) -> dict:
        d = {
            "file": self.path,
            "line": self.line,
            "applies_to": self.applies_to,
            "rules": sorted(self.rules),
        }
        if self.seam_ok is not None:
            d["seam_ok"] = self.seam_ok
        return d


# -- per-file analysis context -----------------------------------------------

# module root whose calls return tensors (the taint source)
_TORCH_ROOT_MODULES = ("torch",)
# tensor attributes that are host metadata, not tensors
_STATIC_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "layout", "requires_grad",
    "is_sparse", "names", "itemsize", "nbytes",
}
# tensor methods whose result lives on the host (a sync, or metadata)
_HOST_METHODS = {
    "cpu", "numpy", "tolist", "item", "dim", "numel", "size", "stride",
    "element_size", "nelement", "data_ptr", "is_contiguous",
    "storage_offset", "get_device", "is_floating_point", "is_complex",
    "untyped_storage",
}
# torch.* calls returning host values or objects, not tensors
_TORCH_METADATA_FUNCS = {
    "is_tensor", "is_floating_point", "is_complex", "numel", "device",
    "dtype", "Generator", "manual_seed", "get_default_dtype", "finfo",
    "iinfo", "Size", "no_grad", "inference_mode", "enable_grad",
    "get_num_threads", "set_num_threads", "set_default_dtype",
    "use_deterministic_algorithms", "are_deterministic_algorithms_enabled",
    "is_grad_enabled", "set_grad_enabled", "from_numpy_dtype", "load",
    "save",
}
# torch sub-modules whose calls return no tensor (devices, streams,
# process groups, the build's facts)
_TORCH_HOST_SUBMODULES = {
    "cuda", "distributed", "backends", "version", "profiler",
    "multiprocessing", "utils", "hub", "jit", "testing",
}


class FileContext:
    """Parsed source + the cross-rule queries every check needs: parent
    links, enclosing scopes, import aliases, suppressions, and a local
    (per-scope) torch-tensor taint."""

    def __init__(self, path: str, source: str):  # photon: entropy(id-keyed AST parent links; in-memory analysis index, never serialized)
        self.path = norm_path(path)
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._parents: Dict[int, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[id(child)] = node
        self.allow_sites: List[AllowSite] = []
        self._suppressed: Dict[int, Set[str]] = {}
        # line -> guard token from '# photon: guarded-by(<lock>|atomic)'
        self.guard_annotations: Dict[int, str] = {}
        # line -> reason string from '# photon: entropy(<reason>)'
        self.entropy_annotations: Dict[int, str] = {}
        self._scan_comments()
        # import aliases
        self.torch_modules: Set[str] = set()  # names aliasing torch[. ...]
        self.numpy_modules: Set[str] = set()  # names aliasing numpy
        self.torch_names: Set[str] = set()  # from torch import <name>
        # names aliasing a torch sub-module with no tensor results
        # (``import torch.distributed as dist``)
        self.torch_host_modules: Set[str] = set()
        self.overlap_modules: Set[str] = set()  # names aliasing ...overlap
        self.overlap_names: Set[str] = set()  # from ...overlap import <n>
        self._scan_imports()
        self._taint_cache: Dict[int, Set[str]] = {}

    # -- structure ----------------------------------------------------------

    def parent(self, node: ast.AST) -> Optional[ast.AST]:  # photon: entropy(id-keyed AST parent lookup; in-memory only)
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def scope_of(self, node: ast.AST) -> ast.AST:
        """Innermost function scope, or the module itself."""
        return self.enclosing_function(node) or self.tree

    def path_parts(self) -> Tuple[str, ...]:
        return tuple(p for p in self.path.split("/") if p)

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def violation(
        self, rule: "Rule", node: ast.AST, message: str, **kw
    ) -> Violation:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Violation(
            rule=rule.id, slug=rule.slug, path=self.path, line=line,
            col=col, message=message, snippet=self.snippet(line), **kw,
        )

    # -- scope queries -------------------------------------------------------

    def scope_calls(self, scope: ast.AST, names: Set[str]) -> bool:
        """Does ``scope`` directly call (or reference) any of ``names``
        (bare name or attribute), not counting nested function bodies?"""
        for node in self.walk_scope(scope):
            if isinstance(node, ast.Name) and node.id in names:
                return True
            if isinstance(node, ast.Attribute) and node.attr in names:
                return True
        return False

    def walk_scope(self, scope: ast.AST) -> Iterator[ast.AST]:
        """Walk a function/module body without descending into nested
        function/class definitions."""
        body = scope.body if hasattr(scope, "body") else []
        stack = list(body)
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child,
                    (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
                     ast.Lambda),
                ):
                    continue
                stack.append(child)

    # -- imports -------------------------------------------------------------

    def _scan_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    top = alias.name.split(".")[0]
                    name = alias.asname or alias.name.split(".")[0]
                    if top in _TORCH_ROOT_MODULES:
                        parts = alias.name.split(".")
                        if alias.asname and len(parts) > 1 and \
                                parts[1] in _TORCH_HOST_SUBMODULES:
                            self.torch_host_modules.add(alias.asname)
                        else:
                            self.torch_modules.add(alias.asname or top)
                    if top == "numpy":
                        self.numpy_modules.add(alias.asname or top)
                    if alias.name.endswith("parallel.overlap"):
                        self.overlap_modules.add(name)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for alias in node.names:
                    name = alias.asname or alias.name
                    if mod.split(".")[0] in _TORCH_ROOT_MODULES:
                        if mod == "torch" and \
                                alias.name in _TORCH_HOST_SUBMODULES:
                            self.torch_host_modules.add(name)
                        elif mod == "torch" and alias.name == "nn":
                            self.torch_modules.add(name)
                        elif mod.split(".")[1:2] and \
                                mod.split(".")[1] in _TORCH_HOST_SUBMODULES:
                            pass
                        else:
                            self.torch_names.add(name)
                    if mod == "numpy":
                        self.numpy_modules.add(name)  # from numpy import *
                    if mod.endswith("parallel.overlap"):
                        self.overlap_names.add(name)
                    if mod.endswith("parallel") and alias.name == "overlap":
                        self.overlap_modules.add(name)

    def is_torch_module(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and node.id in self.torch_modules

    def is_numpy_module(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and node.id in self.numpy_modules

    def is_overlap_module(self, node: ast.AST) -> bool:
        return (
            isinstance(node, ast.Name) and node.id in self.overlap_modules
        )

    # -- suppressions --------------------------------------------------------

    def _scan_comments(self) -> None:
        try:
            tokens = list(
                tokenize.generate_tokens(io.StringIO(self.source).readline)
            )
        except tokenize.TokenError:
            tokens = []
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            g = _GUARDED_RE.search(tok.string)
            if g:
                self.guard_annotations[tok.start[0]] = g.group(1)
            # anchored: the comment must BE the declaration — prose that
            # merely mentions the grammar is not a claim
            en = _ENTROPY_RE.match(tok.string)
            if en:
                self.entropy_annotations[tok.start[0]] = en.group(1).strip()
            m = _ALLOW_RE.search(tok.string)
            if not m:
                continue
            rules = {
                r.strip() for r in m.group(1).split(",") if r.strip()
            }
            line = tok.start[0]
            text_before = self.lines[line - 1][: tok.start[1]].strip()
            applies_to = line if text_before else self._next_code_line(line)
            site = AllowSite(
                line=line, applies_to=applies_to, rules=rules,
                path=self.path,
            )
            self.allow_sites.append(site)
            self._suppressed.setdefault(applies_to, set()).update(rules)

    def _next_code_line(self, comment_line: int) -> int:
        for ln in range(comment_line + 1, len(self.lines) + 1):
            text = self.lines[ln - 1].strip()
            if text and not text.startswith("#"):
                return ln
        return comment_line

    def suppressed(self, violation: Violation) -> bool:
        if not violation.suppressable:
            return False
        toks = self._suppressed.get(violation.line)
        if not toks:
            return False
        return bool(
            toks & {violation.rule, violation.slug, "*", "all"}
        )

    # -- local torch-tensor taint ---------------------------------------------

    def torch_taint(  # photon: entropy(id-keyed per-scope taint memo; in-memory only)
        self, scope: ast.AST,
    ) -> Set[str]:
        """Names in ``scope`` that provably hold torch tensors: parameters
        annotated ``Tensor`` / ``torch.Tensor``, and names assigned from
        ``torch.*`` calls or tensor methods (or derived from such names).
        A tensor method whose result lives on the host (``.cpu()``,
        ``.tolist()``, ``.item()``, ``.size()``, ...) ends the taint."""
        key = id(scope)
        cached = self._taint_cache.get(key)
        if cached is not None:
            return cached
        tainted: Set[str] = set()
        if hasattr(scope, "args"):
            a = scope.args
            for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
                if self._is_tensor_annotation(p.annotation):
                    tainted.add(p.arg)
        # fixpoint over straight-line assignments (monotone, so a couple
        # of passes converge; bound defensively)
        for _ in range(10):
            before = len(tainted)
            for node in self.walk_scope(scope):
                if isinstance(node, ast.Assign):
                    if self.expr_tainted(node.value, tainted):
                        for tgt in node.targets:
                            self._taint_target(tgt, tainted)
                elif isinstance(node, ast.AnnAssign):
                    if (node.value is not None and self.expr_tainted(node.value, tainted)) \
                            or self._is_tensor_annotation(node.annotation):
                        self._taint_target(node.target, tainted)
                elif isinstance(node, ast.AugAssign):
                    if self.expr_tainted(node.value, tainted):
                        self._taint_target(node.target, tainted)
            if len(tainted) == before:
                break
        self._taint_cache[key] = tainted
        return tainted

    def _is_tensor_annotation(self, ann: Optional[ast.AST]) -> bool:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value in ("Tensor", "torch.Tensor")
        if isinstance(ann, ast.Name):
            return ann.id == "Tensor"
        if isinstance(ann, ast.Attribute):
            return ann.attr == "Tensor" and self.is_torch_module(ann.value)
        return False

    def _taint_target(self, target: ast.AST, tainted: Set[str]) -> None:
        if isinstance(target, ast.Name):
            tainted.add(target.id)
        elif isinstance(target, ast.Starred):
            self._taint_target(target.value, tainted)

    def expr_tainted(self, expr: ast.AST, tainted: Set[str]) -> bool:
        """Does this expression (conservatively, low-false-positive)
        evaluate to a torch tensor?"""
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Call):
            func = expr.func
            root = _attr_root(func)
            if isinstance(func, ast.Attribute) and root is not None and \
                    root.id in self.torch_modules and func.value is not None:
                chain = _attr_chain(func)
                if any(part in _TORCH_HOST_SUBMODULES for part in chain[1:-1]):
                    return False
                return func.attr not in _TORCH_METADATA_FUNCS
            if isinstance(func, ast.Name):
                return func.id in self.torch_names and \
                    func.id not in _TORCH_METADATA_FUNCS and func.id != "Tensor"
            if isinstance(func, ast.Attribute):
                # a method on a tensor: x.sum(), x.to(...), but not x.cpu()
                if func.attr in _HOST_METHODS or func.attr in _STATIC_ATTRS:
                    return False
                return self.expr_tainted(func.value, tainted)
            return False
        if isinstance(expr, ast.Attribute):
            if expr.attr in _STATIC_ATTRS:
                return False
            if expr.attr in ("T", "mT", "real", "imag", "grad", "data"):
                return self.expr_tainted(expr.value, tainted)
            return False
        if isinstance(expr, ast.Subscript):
            return self.expr_tainted(expr.value, tainted)
        if isinstance(expr, ast.BinOp):
            return self.expr_tainted(
                expr.left, tainted
            ) or self.expr_tainted(expr.right, tainted)
        if isinstance(expr, ast.UnaryOp):
            return not isinstance(expr.op, ast.Not) and \
                self.expr_tainted(expr.operand, tainted)
        if isinstance(expr, ast.Compare):
            return self.expr_tainted(expr.left, tainted) or any(
                self.expr_tainted(c, tainted) for c in expr.comparators
            )
        if isinstance(expr, ast.IfExp):
            return self.expr_tainted(
                expr.body, tainted
            ) and self.expr_tainted(expr.orelse, tainted)
        return False


def _attr_chain(node: ast.AST) -> List[str]:
    """A dotted chain's names, root first: ``torch.cuda.synchronize`` ->
    [torch, cuda, synchronize]."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _attr_root(node: ast.AST) -> Optional[ast.Name]:
    """Root Name of a dotted chain: ``torch.nn.functional.pad`` -> Name(torch)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node if isinstance(node, ast.Name) else None


def attr_root(node: ast.AST) -> Optional[ast.Name]:
    return _attr_root(node)


def call_name(node: ast.Call) -> str:
    """Trailing callee name: ``overlap.submit_io(...)`` -> ``submit_io``."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


# -- whole-package concurrency model (PL008-PL010) ----------------------------
#
# The second analysis pass. Per class: a GUARD MAP — which ``self._*``
# attributes are written under ``with self._lock``-style context
# managers vs. touched bare, seeded by ``# photon: guarded-by(<lock>)``
# annotations. Per package: a LOCK-ACQUISITION-ORDER GRAPH (nested
# ``with`` blocks + one-hop calls into lock-taking package methods) and
# a THREAD-ESCAPE view (closures handed to ``Thread(target=...)`` /
# ``submit_io``). Everything stays stdlib-``ast``: no imports of the
# package under analysis, so the pass runs in the minimal CI container.

_LOCK_FACTORIES = {"Lock", "RLock"}
_SAFE_FACTORIES = {
    # primitives that are themselves synchronized (or synchronization):
    # calling their methods from several threads is their whole point
    "Event", "Semaphore", "BoundedSemaphore", "Barrier",
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
}
_THREAD_ENTRY_CALLS = {"Thread", "submit_io", "start_new_thread"}
# method names too generic to resolve one-hop by name (dict/list/set and
# primitive protocol collisions would wire the lock graph to noise)
_ONE_HOP_STOPLIST = {
    "get", "pop", "append", "appendleft", "extend", "items", "keys",
    "values", "update", "clear", "copy", "setdefault", "remove",
    "discard", "add", "put", "put_nowait", "get_nowait", "join", "set",
    "is_set", "wait", "notify", "notify_all", "acquire", "release",
    "result", "done", "cancel", "close", "flush", "write", "read",
    "sort", "index", "count", "split", "strip", "startswith", "endswith",
}
# callback-shaped attribute names: user code invoked through these while
# a lock is held runs arbitrary code inside the critical section
_CALLBACK_NAME_RE = re.compile(
    r"^(on_[a-z0-9_]+|[a-z0-9_]*callback[a-z0-9_]*|[a-z0-9_]*hook[a-z0-9_]*"
    r"|[a-z0-9_]+_handler|[a-z0-9_]+_provider)$"
)
# calls that can block for real time: parking on these inside a
# critical section extends everyone's wait, not just the caller's
_BLOCKING_TAILS = {"sendall", "recv", "accept", "connect", "sleep"}

ATOMIC = "atomic"


@dataclass
class AttrAccess:
    """One ``self.<attr>`` touch inside a method."""

    attr: str
    node: ast.AST
    method: str
    kind: str  # "read" | "write" | "augwrite" | "mutate"
    locks_held: frozenset  # class-local base-lock attr names
    # (lock, id-of-acquiring-With) pairs: two accesses sharing a lock
    # NAME but not an acquisition SITE saw the lock released between
    # them — the check-then-act gap PL010 hunts
    lock_acqs: frozenset
    in_init: bool

    @property
    def is_write(self) -> bool:
        return self.kind != "read"


@dataclass
class LockEdge:
    """held -> acquired, with the site that proves it."""

    src: tuple
    dst: tuple
    path: str
    line: int
    via: str  # "nested-with" | "call:<name>"


@dataclass
class ClassModel:
    name: str
    ctx: "FileContext"
    node: ast.ClassDef
    lock_attrs: Set[str] = field(default_factory=set)
    # condition attr -> backing lock attr (itself when constructed bare)
    cond_alias: Dict[str, str] = field(default_factory=dict)
    # base locks that back at least one Condition: their critical
    # sections gate wait/notify wakeups (PL010's "hot" locks)
    cond_backed: Set[str] = field(default_factory=set)
    safe_attrs: Set[str] = field(default_factory=set)
    annotations: Dict[str, str] = field(default_factory=dict)
    accesses: Dict[str, List[AttrAccess]] = field(default_factory=dict)
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    thread_targets: Set[str] = field(default_factory=set)
    thread_reachable: Set[str] = field(default_factory=set)
    acquired_by_method: Dict[str, Set[str]] = field(default_factory=dict)
    # methods annotated '# photon: guarded-by(<lock>)' on their def
    # line: the body is analyzed AS IF the lock were held, and every
    # self-call site must provably hold it (the caller-holds-the-lock
    # helper convention, enforced not trusted)
    lock_expected: Dict[str, str] = field(default_factory=dict)

    _INIT_METHODS = ("__init__", "__post_init__", "__new__")

    @property
    def concurrent(self) -> bool:
        """Does this class participate in the thread plane at all?
        Owning a lock OR spawning a thread both count — a lock with no
        discipline is as suspicious as a thread with no lock."""
        return bool(self.lock_attrs or self.cond_alias or
                    self.thread_targets)

    def resolve_lock(self, attr: str) -> Optional[str]:
        """Lock identity an attr acquisition maps to: a Condition
        constructed over ``self._lock`` guards the SAME critical
        sections as the lock itself."""
        if attr in self.lock_attrs:
            return attr
        if attr in self.cond_alias:
            return self.cond_alias[attr]
        return None

    def lock_names(self) -> Set[str]:
        return set(self.lock_attrs) | set(self.cond_alias)

    def inferred_guard(self, attr: str) -> Optional[str]:
        """The lock this attr's locked writes agree on (None when no
        write outside __init__ ever holds a lock)."""
        counts: Dict[str, int] = {}
        for a in self.accesses.get(attr, ()):
            if a.in_init or not a.is_write:
                continue
            for lk in a.locks_held:
                counts[lk] = counts.get(lk, 0) + 1
        if not counts:
            return None
        return max(sorted(counts), key=lambda k: counts[k])

    def shared_attrs(self) -> Set[str]:
        """Attrs touched on BOTH sides of the thread boundary: by a
        method reachable from a ``Thread(target=self.<m>)`` entry and by
        a method that is not (the external-caller plane)."""
        if not self.thread_targets:
            return set()
        shared: Set[str] = set()
        for attr, accs in self.accesses.items():
            in_thread = any(
                a.method in self.thread_reachable for a in accs
                if not a.in_init
            )
            outside = any(
                a.method not in self.thread_reachable
                and not a.in_init
                for a in accs
            )
            if in_thread and outside:
                shared.add(attr)
        return shared


@dataclass
class ThreadEscape:
    """A closure handed to a thread entry point whose captured name is
    mutated bare on both sides of the spawn."""

    node: ast.AST
    path: str
    name: str  # captured variable
    target: str  # closure/function name (or "<lambda>")
    message: str


class _MethodScanner(ast.NodeVisitor):
    """Walks one method carrying the set of class-local locks held via
    enclosing ``with self.<lock>`` managers. Nested function bodies run
    at an unknown later time, so the held set RESETS inside them."""

    def __init__(self, model: ClassModel, method: str):
        self.m = model
        self.method = method
        self.held: Tuple[Tuple[str, int], ...] = ()  # (lock, with-id)
        self.in_init = method in ClassModel._INIT_METHODS
        self.acquired: Set[str] = set()
        # (node, held-lock-names) pairs for PL010's under-lock call audit
        self.calls_under_lock: List[Tuple[ast.Call, frozenset]] = []
        self.notifies: List[Tuple[ast.Call, str, frozenset]] = []
        # (node, callee, held-lock-names): self.<m>() call sites, for
        # enforcing lock-expected helper methods
        self.self_calls: List[Tuple[ast.Call, str, frozenset]] = []

    # -- helpers -------------------------------------------------------------

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def _record(self, attr: str, node: ast.AST, kind: str) -> None:
        self.m.accesses.setdefault(attr, []).append(AttrAccess(
            attr=attr, node=node, method=self.method, kind=kind,
            locks_held=frozenset(lk for lk, _ in self.held),
            lock_acqs=frozenset(self.held), in_init=self.in_init,
        ))

    # -- traversal -----------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        got: List[Tuple[str, int]] = []
        for item in node.items:
            attr = self._self_attr(item.context_expr)
            lock = self.m.resolve_lock(attr) if attr else None
            if lock is not None:
                got.append((lock, id(node)))
                self.acquired.add(lock)
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        self.held = self.held + tuple(got)
        for stmt in node.body:
            self.visit(stmt)
        if got:
            self.held = self.held[: len(self.held) - len(got)]

    visit_AsyncWith = visit_With

    def _visit_nested(self, node) -> None:
        held, self.held = self.held, ()
        self.generic_visit(node)
        self.held = held

    def visit_FunctionDef(self, node):  # nested def
        self._visit_nested(node)

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._self_attr(node)
        if attr is not None:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self._record(attr, node, "write")
            elif isinstance(node.ctx, ast.Load):
                # self.attr[k] = v / self.attr.x = v / self.attr += v:
                # a LOAD that feeds an in-place mutation of the object
                parent = self.m.ctx.parent(node)
                kind = "read"
                if isinstance(parent, ast.AugAssign) and parent.target is node:
                    kind = "augwrite"
                elif (
                    isinstance(parent, ast.Subscript)
                    and parent.value is node
                    and isinstance(parent.ctx, (ast.Store, ast.Del))
                ):
                    kind = "mutate"
                elif (
                    isinstance(parent, ast.Attribute)
                    and parent.value is node
                    and isinstance(parent.ctx, (ast.Store, ast.Del))
                ):
                    kind = "mutate"
                self._record(attr, node, kind)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = self._self_attr(node.target)
        if attr is not None:
            self._record(attr, node.target, "augwrite")
            self.visit(node.value)
            return
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self.held:
            self.calls_under_lock.append(
                (node, frozenset(lk for lk, _ in self.held))
            )
        if (
            isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
        ):
            self.self_calls.append((
                node, node.func.attr,
                frozenset(lk for lk, _ in self.held),
            ))
        name = call_name(node)
        if name in ("notify", "notify_all") and isinstance(
            node.func, ast.Attribute
        ):
            cond = self._self_attr(node.func.value)
            if cond is not None and cond in self.m.cond_alias:
                self.notifies.append(
                    (node, cond, frozenset(lk for lk, _ in self.held))
                )
        if name in _THREAD_ENTRY_CALLS:
            tgt = None
            for kw in node.keywords:
                if kw.arg == "target":
                    tgt = kw.value
            if tgt is None and name != "Thread" and node.args:
                tgt = node.args[0]
            attr = self._self_attr(tgt) if tgt is not None else None
            if attr is not None:
                self.m.thread_targets.add(attr)
        self.generic_visit(node)


def _build_class_model(ctx: "FileContext", node: ast.ClassDef) -> ClassModel:
    model = ClassModel(name=node.name, ctx=ctx, node=node)
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            model.methods[stmt.name] = stmt
    # pass 1: lock / condition / safe-type attrs + guard annotations
    for meth in model.methods.values():
        for sub in ast.walk(meth):
            if not isinstance(sub, ast.Assign):
                continue
            for tgt in sub.targets:
                if not (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                ):
                    continue
                ann = ctx.guard_annotations.get(sub.lineno)
                if ann is not None:
                    model.annotations.setdefault(tgt.attr, ann)
                if not isinstance(sub.value, ast.Call):
                    continue
                tail = call_name(sub.value)
                if tail in _LOCK_FACTORIES:
                    model.lock_attrs.add(tgt.attr)
                elif tail == "Condition":
                    backing = tgt.attr  # bare Condition() owns its lock
                    if sub.value.args:
                        a0 = sub.value.args[0]
                        if (
                            isinstance(a0, ast.Attribute)
                            and isinstance(a0.value, ast.Name)
                            and a0.value.id == "self"
                        ):
                            backing = a0.attr
                    model.cond_alias[tgt.attr] = backing
                elif tail in _SAFE_FACTORIES:
                    model.safe_attrs.add(tgt.attr)
    # a bare Condition IS its own lock identity
    for cattr, backing in model.cond_alias.items():
        if backing == cattr:
            model.lock_attrs.add(cattr)
        model.cond_backed.add(backing)
    # pass 2: accesses, held-lock context, thread targets, acquisitions
    model._scanners = {}
    for name, meth in model.methods.items():
        sc = _MethodScanner(model, name)
        expect = ctx.guard_annotations.get(meth.lineno)
        if expect is not None:
            lk = model.resolve_lock(expect)
            if lk is not None:
                # caller-holds-the-lock helper: body analyzed with the
                # lock held; call sites are checked by PL008
                model.lock_expected[name] = lk
                sc.held = ((lk, -meth.lineno),)
        for stmt in meth.body:
            sc.visit(stmt)
        model.acquired_by_method[name] = sc.acquired
        model._scanners[name] = sc
    # pass 3: thread reachability (closure over self-method calls)
    reach = set(model.thread_targets)
    frontier = list(reach)
    while frontier:
        m = frontier.pop()
        meth = model.methods.get(m)
        if meth is None:
            continue
        for sub in ast.walk(meth):
            if isinstance(sub, ast.Call):
                callee = sub.func
                if (
                    isinstance(callee, ast.Attribute)
                    and isinstance(callee.value, ast.Name)
                    and callee.value.id == "self"
                    and callee.attr in model.methods
                    and callee.attr not in reach
                ):
                    reach.add(callee.attr)
                    frontier.append(callee.attr)
    model.thread_reachable = reach
    return model


class PackageContext:
    """All FileContexts of one analyzer run + the lazily-built
    concurrency model (class guard maps, the cross-module lock graph,
    thread escapes). Package rules (PL008-PL010) check THIS."""

    def __init__(self, contexts: Sequence["FileContext"]):
        self.contexts: Dict[str, FileContext] = {
            ctx.path: ctx for ctx in contexts
        }
        self._classes: Optional[Dict[str, List[ClassModel]]] = None
        self._module_locks: Optional[Dict[str, Dict[str, tuple]]] = None
        self._edges: Optional[List[LockEdge]] = None
        self._escapes: Optional[List[ThreadEscape]] = None

    def ctx(self, path: str) -> Optional["FileContext"]:
        return self.contexts.get(path)

    # -- class models --------------------------------------------------------

    @property
    def classes(self) -> Dict[str, List[ClassModel]]:
        """path -> class models (module-level classes only)."""
        if self._classes is None:
            self._classes = {}
            for path, ctx in self.contexts.items():
                models = []
                for node in ctx.tree.body:
                    if isinstance(node, ast.ClassDef):
                        models.append(_build_class_model(ctx, node))
                self._classes[path] = models
        return self._classes

    def all_classes(self) -> Iterator[ClassModel]:
        for models in self.classes.values():
            yield from models

    # -- module-level locks --------------------------------------------------

    @property
    def module_locks(self) -> Dict[str, Dict[str, tuple]]:
        """path -> {global name: lock id} for module-scope Lock()s."""
        if self._module_locks is None:
            self._module_locks = {}
            for path, ctx in self.contexts.items():
                found: Dict[str, tuple] = {}
                for node in ctx.tree.body:
                    if not isinstance(node, ast.Assign):
                        continue
                    if not isinstance(node.value, ast.Call):
                        continue
                    if call_name(node.value) not in _LOCK_FACTORIES:
                        continue
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            found[tgt.id] = ("module", path, tgt.id)
                self._module_locks[path] = found
        return self._module_locks

    # -- the lock-acquisition-order graph ------------------------------------

    def _method_lock_index(self) -> Dict[str, List[tuple]]:
        """method name -> lock ids it acquires, across every package
        class (the one-hop call resolution; generic names stoplisted)."""
        index: Dict[str, List[tuple]] = {}
        for model in self.all_classes():
            for mname, acquired in model.acquired_by_method.items():
                if mname in _ONE_HOP_STOPLIST or mname.startswith("__"):
                    continue
                for lk in acquired:
                    index.setdefault(mname, []).append(
                        ("class", model.name, lk)
                    )
        return index

    @property
    def lock_edges(self) -> List[LockEdge]:
        if self._edges is not None:
            return self._edges
        edges: List[LockEdge] = []
        seen: Set[tuple] = set()
        index = self._method_lock_index()

        def add(src, dst, path, line, via):
            key = (src, dst, via.split(":")[0])
            if src == dst and via.startswith("call"):
                # name-resolved self-recursion is usually a different
                # object of the same class; only a syntactic nested
                # with on the same lock is a provable self-deadlock
                return
            if key in seen:
                return
            seen.add(key)
            edges.append(LockEdge(src, dst, path, line, via))

        for path, ctx in self.contexts.items():
            mlocks = self.module_locks.get(path, {})
            for model in self.classes[path]:
                for mname, sc in model._scanners.items():
                    self._edges_in_method(
                        model, mname, mlocks, index, add
                    )
            self._edges_in_module_funcs(ctx, mlocks, index, add)
        self._edges = edges
        return edges

    def _lock_id(self, model: Optional[ClassModel], mlocks, node):
        """Lock identity of a with-item context expr, or None."""
        if model is not None and isinstance(node, ast.Attribute):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                lk = model.resolve_lock(node.attr)
                if lk is not None:
                    return ("class", model.name, lk)
        if isinstance(node, ast.Name) and node.id in mlocks:
            return mlocks[node.id]
        return None

    def _walk_lock_scope(self, model, mlocks, index, add, body, path,
                         held):
        """Recursive with-nesting walk shared by methods and module
        functions: emits held->acquired and held->callee-lock edges."""
        for node in body:
            self._walk_lock_node(model, mlocks, index, add, node, path,
                                 held)

    def _walk_lock_node(self, model, mlocks, index, add, node, path,
                        held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            inner = node.body if isinstance(node.body, list) else [node.body]
            self._walk_lock_scope(
                model, mlocks, index, add, inner, path, [])
            return
        if isinstance(node, ast.ClassDef):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            got = []
            for item in node.items:
                lid = self._lock_id(model, mlocks, item.context_expr)
                if lid is not None:
                    for h in held:
                        add(h, lid, path, node.lineno, "nested-with")
                    got.append(lid)
            self._walk_lock_scope(
                model, mlocks, index, add, node.body, path, held + got)
            return
        if isinstance(node, ast.Call) and held:
            name = call_name(node)
            callee_locks: List[tuple] = []
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"
                and model is not None
            ):
                for lk in (model.acquired_by_method.get(name) or ()):
                    callee_locks.append(("class", model.name, lk))
            elif isinstance(func, ast.Attribute):
                callee_locks.extend(index.get(name, ()))
            for lid in callee_locks:
                for h in held:
                    add(h, lid, path, node.lineno, f"call:{name}")
        for child in ast.iter_child_nodes(node):
            self._walk_lock_node(
                model, mlocks, index, add, child, path, held)

    def _edges_in_method(self, model, mname, mlocks, index, add):
        meth = model.methods[mname]
        self._walk_lock_scope(
            model, mlocks, index, add, meth.body, model.ctx.path, [])

    def _edges_in_module_funcs(self, ctx, mlocks, index, add):
        for node in ctx.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_lock_scope(
                    None, mlocks, index, add, node.body, ctx.path, [])

    def lock_cycles(self) -> List[List[LockEdge]]:
        """Cycles in the acquisition-order graph — each one a potential
        deadlock interleaving (thread A holds L1 wanting L2, thread B
        holds L2 wanting L1). Also surfaces syntactic self-nesting of a
        non-reentrant lock."""
        adj: Dict[tuple, List[LockEdge]] = {}
        for e in self.lock_edges:
            adj.setdefault(e.src, []).append(e)
        cycles: List[List[LockEdge]] = []
        seen_cycles: Set[frozenset] = set()
        for start in sorted(adj):
            stack: List[LockEdge] = []
            on_path: Set[tuple] = set()

            def dfs(nid):
                if len(cycles) > 32:  # defensive bound
                    return
                on_path.add(nid)
                for e in adj.get(nid, ()):
                    if e.dst == start and stack is not None:
                        cyc = stack + [e]
                        key = frozenset(
                            (c.src, c.dst) for c in cyc
                        )
                        if key not in seen_cycles:
                            seen_cycles.add(key)
                            cycles.append(list(cyc))
                    elif e.dst not in on_path:
                        stack.append(e)
                        dfs(e.dst)
                        stack.pop()
                on_path.discard(nid)

            dfs(start)
        return cycles

    # -- thread escapes ------------------------------------------------------

    @property
    def thread_escapes(self) -> List[ThreadEscape]:
        if self._escapes is None:
            self._escapes = []
            for path, ctx in self.contexts.items():
                self._escapes.extend(_find_thread_escapes(ctx))
        return self._escapes


def _mutated_names(body_nodes, *, bare_only: bool,
                   lock_names: Set[str]) -> Set[str]:
    """Names whose OBJECT is mutated (x[k]=, x.a=, x+=) in these nodes.
    With ``bare_only`` the mutation must not sit under any ``with``
    over a known lock name."""
    out: Set[str] = set()

    def walk(node, held):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            got = any(
                isinstance(i.context_expr, ast.Name)
                and i.context_expr.id in lock_names
                for i in node.items
            ) or any(
                isinstance(i.context_expr, ast.Attribute)
                for i in node.items
            )
            for child in node.body:
                walk(child, held or got)
            return
        if isinstance(node, ast.AugAssign) and isinstance(
            node.target, ast.Name
        ):
            if not (bare_only and held):
                out.add(node.target.id)
        if isinstance(node, (ast.Subscript, ast.Attribute)) and isinstance(
            node.ctx, (ast.Store, ast.Del)
        ):
            root = _attr_root(node if isinstance(node, ast.Attribute)
                              else node.value)
            if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name
            ):
                root = node.value
            if root is not None and not (bare_only and held):
                out.add(root.id)
        for child in ast.iter_child_nodes(node):
            walk(child, held)

    for n in body_nodes:
        walk(n, False)
    return out


def _find_thread_escapes(ctx: "FileContext") -> List[ThreadEscape]:
    """Closures handed to thread entry points whose captured mutable
    state is also mutated by the spawning scope, with no lock on the
    closure side — the classic escaped-shared-local race."""
    out: List[ThreadEscape] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name not in _THREAD_ENTRY_CALLS:
            continue
        tgt = None
        for kw in node.keywords:
            if kw.arg == "target":
                tgt = kw.value
        if tgt is None and name in ("submit_io", "start_new_thread") \
                and node.args:
            tgt = node.args[0]
        if tgt is None:
            continue
        if isinstance(tgt, ast.Lambda):
            out.append(ThreadEscape(
                node=node, path=ctx.path, name="", target="<lambda>",
                message=(
                    "thread target is a lambda — hoist it to a named "
                    "function so its captured state is analyzable "
                    "(and guard anything it shares)"
                ),
            ))
            continue
        if not isinstance(tgt, ast.Name):
            continue  # self.<method> targets are the class model's job
        scope = ctx.scope_of(node)
        target_def = None
        for sub in ctx.walk_scope(scope):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and sub.name == tgt.id:
                target_def = sub
        # walk_scope skips nested defs; look one level down explicitly
        if target_def is None and hasattr(scope, "body"):
            for sub in scope.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)) \
                        and sub.name == tgt.id:
                    target_def = sub
        if target_def is None:
            continue
        # names bound to safe factories (queues, events, locks) in the
        # spawning scope are synchronization, not shared state
        safe: Set[str] = set()
        lock_names: Set[str] = set()
        for sub in ctx.walk_scope(scope):
            if isinstance(sub, ast.Assign) and isinstance(
                sub.value, ast.Call
            ):
                tail = call_name(sub.value)
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        if tail in _SAFE_FACTORIES:
                            safe.add(t.id)
                        elif tail in _LOCK_FACTORIES or tail == "Condition":
                            safe.add(t.id)
                            lock_names.add(t.id)
        closure_locals = {
            a.arg for a in (
                list(target_def.args.posonlyargs)
                + list(target_def.args.args)
                + list(target_def.args.kwonlyargs)
            )
        }
        for sub in ast.walk(target_def):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        closure_locals.add(t.id)
        bare_in_closure = _mutated_names(
            target_def.body, bare_only=True, lock_names=lock_names,
        ) - closure_locals - safe
        outer_nodes = [
            n for n in (scope.body if hasattr(scope, "body") else [])
            if n is not target_def
        ]
        outer_mutated = _mutated_names(
            outer_nodes, bare_only=False, lock_names=lock_names,
        ) - safe
        for nm in sorted(bare_in_closure & outer_mutated):
            out.append(ThreadEscape(
                node=node, path=ctx.path, name=nm, target=tgt.id,
                message=(
                    f"'{nm}' is mutated bare inside thread target "
                    f"'{tgt.id}' AND by the spawning scope — an "
                    "escaped shared local; guard both sides with one "
                    "lock or hand results over a queue"
                ),
            ))
    return out


# -- the package ----------------------------------------------------------------

# directories whose files are package code for the rules that treat it
# apart (PL001's allow-site audit): the port's, and the reference's, so
# that the reference's fixtures (tests/lint_fixtures/photon_ml_tpu/) read
# alike to both analyzers
PACKAGE_DIRS = ("photon_ml_tpu_torch", "photon_ml_tpu")


def in_package(ctx: "FileContext") -> bool:
    return any(d in ctx.path_parts() for d in PACKAGE_DIRS)


# -- file walking and reports ------------------------------------------------


def norm_path(path: str) -> str:
    p = os.path.normpath(path)
    try:
        rel = os.path.relpath(p)
        # only relativize when it stays inside the tree (no ../ escapes)
        if not rel.startswith(".."):
            p = rel
    except ValueError:
        pass
    return p.replace(os.sep, "/")


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(
                d for d in dirs
                if d != "__pycache__" and not d.startswith(".")
            )
            for f in sorted(files):
                if f.endswith(".py"):
                    yield os.path.join(root, f)


@dataclass
class Report:
    files: List[str] = field(default_factory=list)
    violations: List[Violation] = field(default_factory=list)
    allow_sites: List[AllowSite] = field(default_factory=list)
    errors: List[Tuple[str, str]] = field(default_factory=list)
    # filled by baseline application (cli)
    baselined: int = 0
    unused_baseline: List[dict] = field(default_factory=list)
    # the PackageContext of the run's second pass (when any package
    # group ran): the wire contract and the entropy inventory read it
    package: Optional["PackageContext"] = None


def _package_groups(package_pass: bool, determinism_pass: bool = True) -> Set[str]:
    groups: Set[str] = set()
    if package_pass:
        groups.add("concurrency")
    if determinism_pass:
        groups.add("determinism")
    return groups


def _run_package_rules(
    report: Report, contexts: Sequence[FileContext], groups: Set[str],
) -> Optional["PackageContext"]:
    """The second pass: rules that need every file at once (the
    concurrency analyzer, the determinism analyzer).
    Suppressions are honored per owning file."""
    if not contexts or not groups:
        return None
    pkg = PackageContext(contexts)
    by_path = {ctx.path: ctx for ctx in contexts}
    for rule in PACKAGE_RULES.values():
        if rule.group not in groups:
            continue
        for v in rule.check(pkg):
            ctx = by_path.get(v.path)
            if ctx is None or not ctx.suppressed(v):
                report.violations.append(v)
    return pkg


def analyze_source(
    path: str, source: str, package_pass: bool = True,
    determinism_pass: bool = True,
) -> Report:
    """Run every registered rule over one in-memory source blob (the
    package pass runs degenerately over the single file)."""
    _load_rules()
    report = Report(files=[norm_path(path)])
    try:
        ctx = FileContext(path, source)
    except SyntaxError as e:
        report.errors.append((norm_path(path), f"syntax error: {e}"))
        return report
    for rule in RULES.values():
        for v in rule.check(ctx):
            if not ctx.suppressed(v):
                report.violations.append(v)
    report.package = _run_package_rules(
        report, [ctx],
        _package_groups(package_pass, determinism_pass),
    )
    report.allow_sites.extend(ctx.allow_sites)
    report.violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return report


def analyze_paths(
    paths: Sequence[str], package_pass: bool = True,
    determinism_pass: bool = True,
) -> Report:
    _load_rules()
    report = Report()
    contexts: List[FileContext] = []
    for fp in iter_python_files(paths):
        try:
            with open(fp, "r", encoding="utf-8") as fh:
                source = fh.read()
        except OSError as e:
            report.errors.append((norm_path(fp), str(e)))
            continue
        report.files.append(norm_path(fp))
        try:
            ctx = FileContext(fp, source)
        except SyntaxError as e:
            report.errors.append((norm_path(fp), f"syntax error: {e}"))
            continue
        for rule in RULES.values():
            for v in rule.check(ctx):
                if not ctx.suppressed(v):
                    report.violations.append(v)
        report.allow_sites.extend(ctx.allow_sites)
        contexts.append(ctx)
    report.package = _run_package_rules(
        report, contexts,
        _package_groups(package_pass, determinism_pass),
    )
    report.violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return report
