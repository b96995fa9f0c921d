"""Whole-package determinism model for PL015-PL018 (the port's copy of
``photon_ml_tpu/lint/determinism.py``; PL018's corpus leg reads
``tests/test_torch_wire.py``).

Every load-bearing gate in this repo is a *bitwise* check — chaos-arm
parity, swap/rollback restore, registry content signatures, crash
resume, the conservation ledger. This module is the static view of the
discipline those checks silently assume: pure stdlib ``ast``, never
importing the code under analysis.

Three per-file site families plus one package-wide inventory:

* **Unordered-order taint (PL015).** ``set``/``frozenset`` literals
  and constructors, ``os.listdir``/``os.scandir``/``os.walk``,
  ``glob.glob`` and set-algebra results mint *unordered* values; the
  taint follows scope-local assignments and order-preserving wrappers
  (``list``/``tuple``/``join``/comprehensions — wrapping a set in a
  list freezes an arbitrary order, it does not impose one) and is
  erased only by ``sorted()``/``min``/``max``. A site is an unordered
  value reaching a serialization or digest sink, or a bare ``for``
  over one inside an artifact-writing scope.

* **Ambient-entropy taint (PL016).** Wall clocks, pids, hostnames,
  ``uuid``, unseeded ``random``, ``os.urandom`` and the
  hash-randomized builtins ``hash()``/``id()`` taint names; the taint
  flows through calls, f-strings and container literals. Sites are
  entropy reaching a serialization/wire/digest sink, a cache-key
  position, an RNG seed, or a ``return`` payload. The *difference of
  two clock readings* is deliberately clean: an elapsed-time
  measurement is the artifact's data, not ambient identity leaking
  into it. Sites are governed by the ``# photon: entropy(<reason>)``
  declaration grammar (see core.py) — a declaration is an enforced
  claim (stale or reasonless ones are themselves violations), never a
  suppression, which is why PL016 also refuses the baseline.

* **Float-accumulation order (PL017).** Host-side ``sum()`` /
  ``math.fsum`` / ``np.sum`` over an unordered-tainted iterable: the
  float result depends on iteration order, so every bitwise gate
  downstream inherits ``PYTHONHASHSEED``. Sort first.

* **Wire-contract inventory (PL018).** A cross-check table over
  ``serving/wire.py``: every ``MSG_*`` constant must have an encoder
  (an ``append_frame`` caller), a decoder branch, a frontend/transport
  dispatch reference, and a fuzz-corpus entry in
  ``tests/test_torch_wire.py`` (the ``WIRE_FUZZ_CORPUS`` dict keyed by
  ``wire.MSG_*``); every named ``WireError`` kind must appear in the
  frontend's error mapping. Like PL011's entry-point table, the
  inventory is machine-built so a new message type cannot ship
  half-wired — and the corpus leg makes a missing fuzz entry a lint
  failure, not a forgotten test.

Taint is scope-local (module globals flow into functions; attributes
and cross-function returns do not) — the ``return`` leg is what makes
producer functions declare their entropy at the source instead.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from photon_ml_tpu_torch.lint.core import (
    FileContext,
    PackageContext,
    attr_root,
    call_name,
)

# -- taxonomies ---------------------------------------------------------------

# Ambient entropy sources, by dotted call name. Kinds:
#   clock   — wall/monotonic clocks (a Sub of two clock reads is clean)
#   ambient — process/host/random identity (pid, uuid, urandom, ...)
#   hash    — builtin hash(): PYTHONHASHSEED-dependent for str/bytes
#   id      — builtin id(): address-dependent, process-local
ENTROPY_CALLS: Dict[str, Tuple[str, str]] = {
    "time.time": ("clock", "time.time()"),
    "time.time_ns": ("clock", "time.time_ns()"),
    "time.monotonic": ("clock", "time.monotonic()"),
    "time.monotonic_ns": ("clock", "time.monotonic_ns()"),
    "time.perf_counter": ("clock", "time.perf_counter()"),
    "time.perf_counter_ns": ("clock", "time.perf_counter_ns()"),
    "time.process_time": ("clock", "time.process_time()"),
    "datetime.now": ("clock", "datetime.now()"),
    "datetime.utcnow": ("clock", "datetime.utcnow()"),
    "datetime.datetime.now": ("clock", "datetime.now()"),
    "datetime.datetime.utcnow": ("clock", "datetime.utcnow()"),
    "date.today": ("clock", "date.today()"),
    "datetime.date.today": ("clock", "date.today()"),
    "os.getpid": ("ambient", "os.getpid()"),
    "os.getppid": ("ambient", "os.getppid()"),
    "os.urandom": ("ambient", "os.urandom()"),
    "os.uname": ("ambient", "os.uname()"),
    "uuid.uuid1": ("ambient", "uuid.uuid1()"),
    "uuid.uuid4": ("ambient", "uuid.uuid4()"),
    "socket.gethostname": ("ambient", "socket.gethostname()"),
    "socket.getfqdn": ("ambient", "socket.getfqdn()"),
    "platform.node": ("ambient", "platform.node()"),
    "secrets.token_hex": ("ambient", "secrets.token_hex()"),
    "secrets.token_bytes": ("ambient", "secrets.token_bytes()"),
    "secrets.token_urlsafe": ("ambient", "secrets.token_urlsafe()"),
}

# module-level functions of the global (unseeded) random instance
_RANDOM_MODULE_FNS = {
    "random", "randint", "uniform", "choice", "choices", "randrange",
    "getrandbits", "sample", "gauss", "shuffle", "random_sample",
}

# Unordered-iteration mints, by dotted call name.
UNORDERED_CALLS: Dict[str, str] = {
    "set": "set(...)",
    "frozenset": "frozenset(...)",
    "os.listdir": "os.listdir(...)",
    "os.scandir": "os.scandir(...)",
    "os.walk": "os.walk(...)",
    "glob.glob": "glob.glob(...)",
    "glob.iglob": "glob.iglob(...)",
}

# set-algebra methods: the result is a set regardless of the receiver
_SET_METHODS = {
    "union", "intersection", "difference", "symmetric_difference",
}

# order-erasing calls: the unordered taint stops here
_ORDER_ERASERS = {"sorted", "min", "max", "len", "any", "all", "bool",
                  "count"}

# order-preserving wrappers: list(set(...)) freezes an arbitrary order
_ORDER_KEEPERS = {"list", "tuple", "iter", "enumerate", "reversed",
                  "join", "map", "filter", "chain"}

# -- sinks --------------------------------------------------------------------

# repo writer/serializer helpers, by trailing call name
SERIALIZE_SINKS = {
    "atomic_write_json", "atomic_write_text", "atomic_write_bytes",
    "write_manifest", "write_container", "write_datum",
    "write_models_in_text", "save_glm_models_avro", "write_sharding_md",
    "write_html_report", "_write_lines", "_write_parts", "build_store",
    "save_name_and_term_feature_sets",
}

# wire-plane encoders (serving/wire.py)
WIRE_SINKS = {
    "append_frame", "append_json", "append_score_request",
    "append_response",
}

# digest constructors: their args are sink positions, and names bound
# to them become digest objects whose .update() is a sink
DIGEST_CALLS = {"blake2b", "sha256", "sha1", "md5", "sha384", "sha512"}

# names whose presence marks a scope as artifact-writing (the PL015
# bare-for-loop leg only fires inside such scopes)
_SINK_SCOPE_NAMES = (
    SERIALIZE_SINKS | WIRE_SINKS | DIGEST_CALLS
    | {"dump", "dumps", "atomic_writer"}
)

_CACHE_KEY_METHODS = {"get", "setdefault", "pop"}
_SEED_SINKS = {"seed", "Random", "default_rng", "PRNGKey"}


def _dotted(call: ast.Call) -> str:
    parts: List[str] = []
    f = call.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if not isinstance(f, ast.Name):
        return ""
    parts.append(f.id)
    return ".".join(reversed(parts))


def _is_json_dump(call: ast.Call) -> bool:
    name = call_name(call)
    if name not in ("dump", "dumps"):
        return False
    func = call.func
    if isinstance(func, ast.Name):  # from json import dumps
        return True
    root = attr_root(func)
    return root is not None and root.id in ("json", "pickle", "marshal")


# -- per-file model -----------------------------------------------------------

Site = Tuple[ast.AST, str]  # (node, message)


class DeterminismFileModel:
    """Scope-local taint + determinism sites for one file."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.pl015: List[Site] = []
        self.pl016: List[Site] = []
        self.pl017: List[Site] = []
        self.stale: List[Tuple[int, str]] = []
        self.consumed: Set[int] = set()
        # module-scope taints seed every function scope
        self._module_et: Dict[str, Tuple[str, str]] = {}
        self._module_ut: Dict[str, str] = {}
        self._seen: Set[Tuple[int, str]] = set()
        self._build()

    # -- entropy expression walk ---------------------------------------------

    def _entropy_call(
        self, call: ast.Call, et: Dict[str, Tuple[str, str]]
    ) -> Optional[Tuple[str, str]]:
        dotted = _dotted(call)
        hit = ENTROPY_CALLS.get(dotted)
        if hit:
            return hit
        func = call.func
        if isinstance(func, ast.Name):
            if func.id == "hash":
                return ("hash", "hash() (PYTHONHASHSEED-dependent)")
            if func.id == "id":
                return ("id", "id() (address-dependent)")
        root = attr_root(func)
        if root is not None and root.id == "random" and isinstance(
            func, ast.Attribute
        ) and func.attr in _RANDOM_MODULE_FNS:
            return ("ambient", f"unseeded random.{func.attr}()")
        # Random()/default_rng() with no seed argument
        if call_name(call) in ("Random", "default_rng") and not call.args \
                and not call.keywords:
            return ("ambient", f"unseeded {call_name(call)}()")
        return None

    def _edesc(
        self, e: Optional[ast.AST], et: Dict[str, Tuple[str, str]]
    ) -> Optional[Tuple[str, str]]:
        if e is None or isinstance(e, (ast.Constant, ast.Lambda,
                                       ast.Compare)):
            # a comparison yields a decision, not entropy content
            return None
        if isinstance(e, ast.Name):
            return et.get(e.id)
        if isinstance(e, ast.Call):
            src = self._entropy_call(e, et)
            if src:
                return src
            if isinstance(e.func, ast.Attribute) and \
                    e.func.attr in _CACHE_KEY_METHODS:
                # the value looked up BY an entropic key is not itself
                # entropy — the cache-key leg flags the lookup
                return None
            for sub in list(e.args) + [kw.value for kw in e.keywords]:
                d = self._edesc(sub, et)
                if d:
                    return d
            if isinstance(e.func, ast.Attribute):
                # tainted.hex(), tainted.isoformat(), ...
                return self._edesc(e.func.value, et)
            return None
        if isinstance(e, ast.BinOp):
            left = self._edesc(e.left, et)
            right = self._edesc(e.right, et)
            if isinstance(e.op, ast.Sub) and (
                (left and left[0] == "clock")
                or (right and right[0] == "clock")
            ):
                # clock minus anything (or anything minus clock) is an
                # elapsed/remaining interval — a measurement, not
                # ambient identity; any non-clock entropy still flows
                for d in (left, right):
                    if d and d[0] != "clock":
                        return d
                return None
            return left or right
        if isinstance(e, ast.Subscript):
            # element access: the container's taint, not the key's
            return self._edesc(e.value, et)
        if isinstance(e, ast.Attribute):
            return self._edesc(e.value, et)
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                d = self._edesc(child, et)
            elif isinstance(child, ast.keyword):
                d = self._edesc(child.value, et)
            elif isinstance(child, ast.comprehension):
                d = self._edesc(child.iter, et)
            else:
                d = None
            if d:
                return d
        return None

    # -- unordered expression walk -------------------------------------------

    def _udesc(
        self, e: Optional[ast.AST], ut: Dict[str, str]
    ) -> Optional[str]:
        if e is None or isinstance(e, (ast.Constant, ast.Lambda)):
            return None
        if isinstance(e, ast.Name):
            return ut.get(e.id)
        if isinstance(e, ast.Set):
            return "set literal"
        if isinstance(e, ast.SetComp):
            return "set comprehension"
        if isinstance(e, ast.Call):
            name = call_name(e)
            if name in _ORDER_ERASERS or name == "sum":
                return None  # sorted()/min()/... erase; sum is PL017's
            dotted = _dotted(e)
            if dotted in UNORDERED_CALLS:
                return UNORDERED_CALLS[dotted]
            if isinstance(e.func, ast.Name) and e.func.id in (
                "set", "frozenset"
            ):
                return f"{e.func.id}(...)"
            if isinstance(e.func, ast.Attribute) and \
                    e.func.attr in _SET_METHODS:
                return f".{e.func.attr}(...)"
            if name in _ORDER_KEEPERS:
                subs = list(e.args) + [kw.value for kw in e.keywords]
                if name == "join" and isinstance(e.func, ast.Attribute):
                    pass  # sep.join(unordered): check args only
                for sub in subs:
                    d = self._udesc(sub, ut)
                    if d:
                        return d
            return None
        if isinstance(e, ast.BinOp) and isinstance(
            e.op, (ast.BitAnd, ast.BitOr, ast.BitXor, ast.Sub)
        ):
            return self._udesc(e.left, ut) or self._udesc(e.right, ut)
        if isinstance(e, (ast.ListComp, ast.GeneratorExp, ast.DictComp)):
            for gen in e.generators:
                d = self._udesc(gen.iter, ut)
                if d:
                    return d
            return None
        if isinstance(e, ast.IfExp):
            return self._udesc(e.body, ut) or self._udesc(e.orelse, ut)
        if isinstance(e, (ast.Tuple, ast.List)):
            for el in e.elts:
                d = self._udesc(el, ut)
                if d:
                    return d
            return None
        if isinstance(e, ast.Dict):
            # a dict literal payload: unordered order leaks through its
            # VALUES (and ** spreads, keys=None); dict insertion order
            # itself is stable
            for k, v in zip(e.keys, e.values):
                d = self._udesc(v, ut)
                if d:
                    return d
                if k is not None:
                    d = self._udesc(k, ut)
                    if d:
                        return d
            return None
        if isinstance(e, ast.Starred):
            return self._udesc(e.value, ut)
        return None

    # -- strict scope walk ----------------------------------------------------

    _SCOPE_BARRIERS = (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef, ast.Lambda)

    def _scope_walk(self, scope: ast.AST) -> Iterator[ast.AST]:
        """Every node of ``scope``'s own body, never entering a nested
        def/class/lambda — including ones that sit directly in the
        body (which ``FileContext.walk_scope`` descends into)."""
        body = scope.body if hasattr(scope, "body") else []
        stack = [c for c in body
                 if not isinstance(c, self._SCOPE_BARRIERS)]
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, self._SCOPE_BARRIERS):
                    stack.append(child)

    # -- declaration plumbing -------------------------------------------------

    def _stmt_of(self, node: ast.AST, scope: ast.AST) -> ast.AST:
        cur, last = node, node
        while cur is not None and cur is not scope:
            last = cur
            cur = self.ctx.parent(cur)
        return last

    def _declared(self, node: ast.AST, scope: ast.AST) -> Optional[int]:
        """The entropy-declaration line covering this site, if any:
        the site's own line, its enclosing statement's first line, or
        the scope's def line (or the line just above it/its first
        decorator)."""
        ann = self.ctx.entropy_annotations
        cand = {getattr(node, "lineno", 0)}
        stmt = self._stmt_of(node, scope)
        cand.add(getattr(stmt, "lineno", 0))
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cand.add(scope.lineno)
            cand.add(scope.lineno - 1)
            if scope.decorator_list:
                cand.add(scope.decorator_list[0].lineno - 1)
        for ln in sorted(cand):
            if ln in ann:
                return ln
        return None

    # -- scope passes ---------------------------------------------------------

    def _targets(self, tgt: ast.AST) -> Iterator[str]:
        if isinstance(tgt, ast.Name):
            yield tgt.id
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                yield from self._targets(el)
        elif isinstance(tgt, ast.Starred):
            yield from self._targets(tgt.value)

    def _taint_pass(
        self,
        scope: ast.AST,
        et: Dict[str, Tuple[str, str]],
        ut: Dict[str, str],
        dt: Set[str],
        module_scope: bool,
    ) -> None:
        ann = self.ctx.entropy_annotations
        stmts = [
            n for n in self._scope_walk(scope)
            if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign,
                              ast.For))
        ]
        stmts.sort(key=lambda n: (n.lineno, n.col_offset))
        for _ in range(2):
            for st in stmts:
                if isinstance(st, ast.For):
                    if self._udesc(st.iter, ut) is None and \
                            self._edesc(st.iter, et) is None:
                        for name in self._targets(st.target):
                            et.pop(name, None)
                            ut.pop(name, None)
                    continue
                if isinstance(st, ast.AugAssign):
                    if isinstance(st.target, ast.Name):
                        d = self._edesc(st.value, et)
                        if d:
                            et[st.target.id] = d
                    continue
                value = st.value
                if value is None:
                    continue
                targets = st.targets if isinstance(st, ast.Assign) \
                    else [st.target]
                declared = st.lineno in ann
                ed = self._edesc(value, et)
                ud = self._udesc(value, ut)
                is_digest = isinstance(value, ast.Call) and \
                    call_name(value) in DIGEST_CALLS
                for name in (n for t in targets
                             for n in self._targets(t)):
                    if ed and declared:
                        # a declared mint: the name is clean downstream
                        self.consumed.add(st.lineno)
                        et.pop(name, None)
                    elif ed:
                        et[name] = ed
                    else:
                        et.pop(name, None)
                    if ud:
                        ut[name] = ud
                    else:
                        ut.pop(name, None)
                    if is_digest:
                        dt.add(name)

    def _site_pass(
        self,
        scope: ast.AST,
        et: Dict[str, Tuple[str, str]],
        ut: Dict[str, str],
        dt: Set[str],
    ) -> None:
        ctx = self.ctx
        nodes = list(self._scope_walk(scope))
        sink_scope = any(
            (isinstance(n, ast.Name) and n.id in _SINK_SCOPE_NAMES)
            or (isinstance(n, ast.Attribute)
                and n.attr in _SINK_SCOPE_NAMES)
            for n in nodes
        )

        def flag(rule_sites: List[Site], node: ast.AST, msg: str,
                 declarable: bool = False) -> None:
            key = (getattr(node, "lineno", 0), id(rule_sites))
            if key in self._seen:
                return
            if declarable:
                ln = self._declared(node, scope)
                if ln is not None:
                    self.consumed.add(ln)
                    return
            self._seen.add(key)
            rule_sites.append((node, msg))

        for node in nodes:
            if isinstance(node, ast.Call):
                name = call_name(node)
                args = list(node.args) + [kw.value for kw in node.keywords]
                is_sink = (
                    name in SERIALIZE_SINKS or name in WIRE_SINKS
                    or name in DIGEST_CALLS or _is_json_dump(node)
                    or (name == "update"
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in dt)
                )
                if is_sink:
                    sink = name if name != "update" else "digest.update"
                    for a in args:
                        ud = self._udesc(a, ut)
                        if ud:
                            flag(self.pl015, a, (
                                f"unordered {ud} reaches the "
                                f"{sink}(...) sink — artifact bytes "
                                "inherit hash/filesystem order; apply "
                                "sorted() before serializing"
                            ))
                        ed = self._edesc(a, et)
                        if ed:
                            flag(self.pl016, a, (
                                f"{ed[1]} flows into {sink}(...) — "
                                "artifact bytes inherit ambient "
                                "entropy; derive the value from "
                                "content or declare it with "
                                "'# photon: entropy(<reason>)'"
                            ), declarable=True)
                if name in _SEED_SINKS:
                    for a in args:
                        ed = self._edesc(a, et)
                        if ed:
                            flag(self.pl016, a, (
                                f"{ed[1]} seeds {name}(...) — "
                                "downstream draws depend on ambient "
                                "state; seed from stable content "
                                "(e.g. zlib.crc32/blake2b of the key) "
                                "or declare it"
                            ), declarable=True)
                if name in _CACHE_KEY_METHODS and node.args:
                    ed = self._edesc(node.args[0], et)
                    if ed and ed[0] != "hash":
                        flag(self.pl016, node, (
                            f"{ed[1]} used as a cache/map key via "
                            f".{name}(...) — entries can never be "
                            "re-keyed across runs; key by content or "
                            "declare the identity-keying"
                        ), declarable=True)
                # PL017: order-dependent float accumulation
                is_sum = (
                    (isinstance(node.func, ast.Name)
                     and node.func.id in ("sum", "fsum"))
                    or _dotted(node) == "math.fsum"
                    or (isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("sum", "fsum")
                        and attr_root(node.func) is not None
                        and (ctx.is_numpy_module(attr_root(node.func))
                             or attr_root(node.func).id
                             in ("np", "numpy", "math")))
                )
                if is_sum and node.args:
                    ud = self._udesc(node.args[0], ut)
                    if ud:
                        flag(self.pl017, node, (
                            f"{name}() over unordered {ud} — float "
                            "accumulation order follows hash order, "
                            "so the result is not bitwise stable; "
                            "iterate sorted()"
                        ))
            elif isinstance(node, ast.For):
                ud = self._udesc(node.iter, ut)
                if ud and sink_scope:
                    flag(self.pl015, node, (
                        f"iterating unordered {ud} in a scope that "
                        "writes artifacts/digests — emit in sorted() "
                        "order so the bytes are reproducible"
                    ))
            elif isinstance(node, ast.Subscript):
                ed = self._edesc(node.slice, et)
                if ed and ed[0] != "hash":
                    flag(self.pl016, node, (
                        f"{ed[1]} used as a subscript cache key — "
                        "entries can never be re-keyed across runs; "
                        "key by content or declare the "
                        "identity-keying"
                    ), declarable=True)
            elif isinstance(node, ast.Return):
                ed = self._edesc(node.value, et)
                if ed:
                    flag(self.pl016, node, (
                        f"{ed[1]} in a return payload — callers "
                        "serialize this; declare the entropy at its "
                        "source with '# photon: entropy(<reason>)' "
                        "or derive it from content"
                    ), declarable=True)

    def _build(self) -> None:
        ctx = self.ctx
        # module scope first: declared module mints clear their names
        et: Dict[str, Tuple[str, str]] = {}
        ut: Dict[str, str] = {}
        dt: Set[str] = set()
        self._taint_pass(ctx.tree, et, ut, dt, module_scope=True)
        self._module_et, self._module_ut = dict(et), dict(ut)
        self._site_pass(ctx.tree, et, ut, dt)
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fet = dict(self._module_et)
                fut = dict(self._module_ut)
                # parameters shadow module taints
                a = node.args
                for p in (list(a.posonlyargs) + list(a.args)
                          + list(a.kwonlyargs)):
                    fet.pop(p.arg, None)
                    fut.pop(p.arg, None)
                fdt: Set[str] = set()
                self._taint_pass(node, fet, fut, fdt, module_scope=False)
                self._site_pass(node, fet, fut, fdt)
        # enforced-claim audit: reasonless or unconsumed declarations
        for line, reason in sorted(ctx.entropy_annotations.items()):
            if not reason.strip():
                self.stale.append((line, (
                    "entropy declaration without a reason — the "
                    "grammar is '# photon: entropy(<why this site "
                    "must be nondeterministic>)'"
                )))
            elif line not in self.consumed:
                self.stale.append((line, (
                    "stale entropy declaration — no ambient entropy "
                    "reaches an artifact from this line; delete the "
                    "declaration so the contract stays trustworthy"
                )))

    def declarations(self) -> List[dict]:
        out = []
        for line, reason in sorted(self.ctx.entropy_annotations.items()):
            out.append({
                "file": self.ctx.path,
                "line": line,
                "reason": reason,
                "status": "active" if line in self.consumed else "stale",
            })
        return out


def file_model(ctx: FileContext) -> DeterminismFileModel:
    cached = getattr(ctx, "_det_model", None)
    if cached is None:
        cached = DeterminismFileModel(ctx)
        ctx._det_model = cached
    return cached


# -- wire-contract inventory (PL018) ------------------------------------------

@dataclass
class WireMessage:
    name: str
    value: int
    node: ast.AST
    encoders: List[str] = field(default_factory=list)
    decoded: bool = False
    dispatch: List[str] = field(default_factory=list)
    in_corpus: Optional[bool] = None  # None: corpus not checkable

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "value": self.value,
            "encoders": sorted(self.encoders),
            "decoded": self.decoded,
            "dispatch": sorted(self.dispatch),
            "in_corpus": self.in_corpus,
        }


@dataclass
class WireContract:
    path: str
    messages: List[WireMessage]
    error_kinds: Dict[str, bool]  # kind -> mapped in frontend
    corpus_path: Optional[str]
    corpus_checked: bool
    corpus_node: Optional[ast.AST] = None

    def to_dict(self) -> dict:
        return {
            "wire_module": self.path,
            "messages": [m.to_dict() for m in self.messages],
            "error_kinds": dict(sorted(self.error_kinds.items())),
            "corpus": self.corpus_path,
            "corpus_checked": self.corpus_checked,
        }


_CORPUS_NAME = "WIRE_FUZZ_CORPUS"


def _msg_names(tree: ast.AST) -> Iterator[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id.startswith("MSG_"):
            yield node.id
        elif isinstance(node, ast.Attribute) and \
                node.attr.startswith("MSG_"):
            yield node.attr


def build_wire_contract(pkg: PackageContext) -> Optional[WireContract]:
    wire_ctx = None
    for path in sorted(pkg.contexts):
        if path.endswith("serving/wire.py"):
            wire_ctx = pkg.contexts[path]
            break
    if wire_ctx is None:
        return None
    messages: Dict[str, WireMessage] = {}
    for node in wire_ctx.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id.startswith("MSG_") and \
                isinstance(node.value, ast.Constant) and \
                isinstance(node.value.value, int):
            name = node.targets[0].id
            messages[name] = WireMessage(
                name=name, value=node.value.value, node=node,
            )
    error_kinds: Dict[str, bool] = {}
    for node in ast.walk(wire_ctx.tree):
        if isinstance(node, ast.FunctionDef):
            # encoder leg: append_frame(buf, MSG_X, ...) inside a def
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and \
                        call_name(sub) == "append_frame" and \
                        len(sub.args) >= 2 and \
                        isinstance(sub.args[1], ast.Name):
                    msg = messages.get(sub.args[1].id)
                    if msg is not None and node.name not in msg.encoders:
                        msg.encoders.append(node.name)
            # decoder leg: MSG_X referenced inside a decode* function
            if "decode" in node.name:
                for ref in _msg_names(node):
                    if ref in messages:
                        messages[ref].decoded = True
        elif isinstance(node, ast.Call) and \
                call_name(node) == "WireError":
            for kw in node.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                    error_kinds.setdefault(str(kw.value.value), False)
        elif isinstance(node, ast.ClassDef) and node.name == "WireError":
            # default kind from __init__'s keyword default
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef,)) and \
                        sub.name == "__init__":
                    for p, d in zip(sub.args.kwonlyargs,
                                    sub.args.kw_defaults):
                        if p.arg == "kind" and \
                                isinstance(d, ast.Constant):
                            error_kinds.setdefault(str(d.value), False)
    # dispatch leg: MSG_* referenced by the frontend or the transport
    frontend_consts: Set[str] = set()
    for path in sorted(pkg.contexts):
        if path.endswith("serving/frontend.py") or \
                path.endswith("serving/routing.py"):
            short = path.rsplit("/", 1)[-1]
            for ref in _msg_names(pkg.contexts[path].tree):
                if ref in messages and \
                        short not in messages[ref].dispatch:
                    messages[ref].dispatch.append(short)
            if path.endswith("serving/frontend.py"):
                for node in ast.walk(pkg.contexts[path].tree):
                    if isinstance(node, ast.Constant) and \
                            isinstance(node.value, str):
                        frontend_consts.add(node.value)
    for kind in error_kinds:
        error_kinds[kind] = kind in frontend_consts
    # corpus leg: tests/test_torch_wire.py's WIRE_FUZZ_CORPUS dict, resolved
    # relative to the analyzed wire module (only checkable when the
    # tests tree is reachable — fixture runs skip this leg)
    corpus_path = None
    corpus_checked = False
    corpus_node = None
    corpus_keys: Set[str] = set()
    if wire_ctx.path.endswith("photon_ml_tpu_torch/serving/wire.py"):
        root = wire_ctx.path[: -len("photon_ml_tpu_torch/serving/wire.py")]
        cand = os.path.join(root, "tests", "test_torch_wire.py") if root \
            else os.path.join("tests", "test_torch_wire.py")
        if os.path.exists(cand):
            corpus_path = cand.replace(os.sep, "/")
            try:
                with open(cand, "r", encoding="utf-8") as fh:
                    test_tree = ast.parse(fh.read())
            except (OSError, SyntaxError):
                test_tree = None
            if test_tree is not None:
                corpus_checked = True
                for node in ast.walk(test_tree):
                    if isinstance(node, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == _CORPUS_NAME
                        for t in node.targets
                    ):
                        corpus_node = node
                        if isinstance(node.value, ast.Dict):
                            for k in node.value.keys:
                                for ref in _msg_names(k):
                                    corpus_keys.add(ref)
    if corpus_checked:
        for msg in messages.values():
            msg.in_corpus = msg.name in corpus_keys
    return WireContract(
        path=wire_ctx.path,
        messages=[messages[k] for k in sorted(messages)],
        error_kinds=error_kinds,
        corpus_path=corpus_path,
        corpus_checked=corpus_checked,
        corpus_node=corpus_node,
    )


def wire_contract(pkg: PackageContext) -> Optional[WireContract]:
    cached = getattr(pkg, "_det_wire", False)
    if cached is False:
        cached = build_wire_contract(pkg)
        pkg._det_wire = cached
    return cached


def entropy_inventory(pkg: PackageContext) -> List[dict]:
    """The --json entropy-declaration table: every declaration in the
    run, with whether the analyzer saw it consumed."""
    out: List[dict] = []
    for path in sorted(pkg.contexts):
        out.extend(file_model(pkg.contexts[path]).declarations())
    return out


__all__ = [
    "DIGEST_CALLS",
    "DeterminismFileModel",
    "ENTROPY_CALLS",
    "SERIALIZE_SINKS",
    "UNORDERED_CALLS",
    "WIRE_SINKS",
    "WireContract",
    "WireMessage",
    "build_wire_contract",
    "entropy_inventory",
    "file_model",
    "wire_contract",
]
