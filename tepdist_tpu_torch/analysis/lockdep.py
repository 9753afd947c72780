"""AST-based concurrency lockdep for the tepdist_tpu_torch package: the
port of ``tepdist_tpu/analysis/lockdep.py`` (pure ``ast``, copied so the
port imports nothing of the JAX package).

The port runs threads on its hot paths: the serving engine's daemon and
the supervisor's recovery path, the executor's per-device threads, the
distributed executor and its heartbeats, the fleet router, and the
server's pools. This module lints every module of the package that
touches :mod:`threading`:

1. **Lock registry** — every ``self.x = threading.Lock()/RLock()/
   Condition()/Semaphore()`` (or the named
   :mod:`~tepdist_tpu_torch.analysis.lockdep_runtime` factories
   ``make_lock/make_rlock/make_condition``) becomes a lock id
   ``ClassName.attr`` (or ``module:name`` at module scope).
2. **Lock-order graph** — a ``with``-acquisition of lock B while
   holding lock A adds edge A → B; edges are also propagated
   inter-procedurally (a call made while holding A contributes A → every
   lock the callee may transitively acquire, via a fixed point over the
   call graph). Any strongly-connected component in the graph is a
   potential ABBA deadlock and is reported as ``lock_inversion`` with
   example sites in both directions.
3. **Hygiene lints** — ``bare_acquire`` (``.acquire()`` on a known lock
   outside ``with``/try-finally) and ``blocking_under_lock``
   (``Condition.wait`` with no timeout, zero-arg ``Thread.join``,
   ``queue.get/put`` with neither timeout nor ``block=False``, RPC
   ``.call(...)``, ``time.sleep``) while a known lock is held.

Findings carry a stable key
``kind:relpath:Class.func:detail`` (no line numbers, so edits don't
churn the allowlist) matched against ``analysis/lockdep_allow.toml`` —
every allowlist entry needs a one-line justification, and no
``lock_inversion`` is ever allowlisted. The CLI is
``tools/torch_lockdep.py``; ``--check`` exits non-zero on any
un-allowlisted finding.

Runtime ground truth lives in :mod:`tepdist_tpu_torch.analysis.
lockdep_runtime`: under ``TEPDIST_LOCKDEP=1`` the instrumented lock
wrappers record actual acquisition-order edges, used to confirm or
retire the static edges reported here.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
              "BoundedSemaphore"}
LOCK_FACTORIES = {"make_lock", "make_rlock", "make_condition"}
QUEUE_CTORS = {"Queue", "LifoQueue", "PriorityQueue", "SimpleQueue"}


@dataclasses.dataclass
class Finding:
    kind: str         # lock_inversion | bare_acquire | blocking_under_lock
    file: str         # repo-relative path
    func: str         # qualified function (Class.method or function)
    detail: str       # stable discriminator (op@lock, lockA<->lockB)
    line: int
    message: str

    @property
    def key(self) -> str:
        return f"{self.kind}:{self.file}:{self.func}:{self.detail}"


@dataclasses.dataclass
class OrderEdge:
    outer: str
    inner: str
    file: str
    func: str
    line: int
    via: str = ""     # call chain note for inter-procedural edges


@dataclasses.dataclass
class _FuncInfo:
    """Per-function facts gathered in one AST pass."""
    qual: str                      # Class.method or function name
    file: str
    cls: Optional[str]
    acquires: Set[str] = dataclasses.field(default_factory=set)
    # calls made while holding locks: (callee_token, held_snapshot, line)
    calls: List[Tuple[str, Tuple[str, ...], int]] = dataclasses.field(
        default_factory=list)
    trans_acquires: Set[str] = dataclasses.field(default_factory=set)


# ---------------------------------------------------------------------
# pass 1: lock / queue registry
# ---------------------------------------------------------------------

def _lock_ctor_id(value: ast.AST) -> Optional[str]:
    """If ``value`` constructs a lock, return the factory's literal name
    (for make_* calls) or "" for anonymous threading ctors; else None."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "threading" and f.attr in LOCK_CTORS:
        return ""
    name = f.id if isinstance(f, ast.Name) else (
        f.attr if isinstance(f, ast.Attribute) else None)
    if name in LOCK_FACTORIES:
        if value.args and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            return value.args[0].value
        return ""
    return None


def _is_queue_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id == "queue" and f.attr in QUEUE_CTORS:
        return True
    return isinstance(f, ast.Name) and f.id in QUEUE_CTORS


class _Registry:
    def __init__(self):
        self.locks: Set[str] = set()
        # attr name -> lock ids using it (for x.attr resolution)
        self.by_attr: Dict[str, Set[str]] = {}
        self.queue_attrs: Set[str] = set()

    def add(self, lock_id: str, attr: Optional[str]) -> None:
        self.locks.add(lock_id)
        if attr:
            self.by_attr.setdefault(attr, set()).add(lock_id)

    def resolve(self, expr: ast.AST, cls: Optional[str]) -> Optional[str]:
        """Map a lock expression to a registered lock id."""
        if isinstance(expr, ast.Attribute):
            attr = expr.attr
            recv = expr.value
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls") \
                    and cls and f"{cls}.{attr}" in self.locks:
                return f"{cls}.{attr}"
            cands = self.by_attr.get(attr, set())
            if len(cands) == 1:
                return next(iter(cands))
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
                # Ambiguous attr on self with no class match: unknown.
                return None
            return None
        if isinstance(expr, ast.Name):
            for lid in self.locks:
                if lid.endswith(f":{expr.id}"):
                    return lid
        return None


def _collect_registry(modules: Dict[str, ast.Module]) -> _Registry:
    reg = _Registry()
    for rel, tree in modules.items():
        modname = os.path.splitext(os.path.basename(rel))[0]
        for node in tree.body:
            # module-level: NAME = threading.Lock()
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                lit = _lock_ctor_id(node.value)
                if lit is not None:
                    reg.add(lit or f"{modname}:{node.targets[0].id}",
                            node.targets[0].id)
            if not isinstance(node, ast.ClassDef):
                continue
            cls = node.name
            for stmt in node.body:
                # class-body: _lock = threading.Lock()
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    lit = _lock_ctor_id(stmt.value)
                    if lit is not None:
                        reg.add(lit or f"{cls}.{stmt.targets[0].id}",
                                stmt.targets[0].id)
            for meth in ast.walk(node):
                # method-body: self.x = threading.Lock() / make_*("...")
                if not isinstance(meth, ast.Assign) \
                        or len(meth.targets) != 1:
                    continue
                tgt = meth.targets[0]
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self":
                    lit = _lock_ctor_id(meth.value)
                    if lit is not None:
                        reg.add(lit or f"{cls}.{tgt.attr}", tgt.attr)
                    elif _is_queue_ctor(meth.value):
                        reg.queue_attrs.add(tgt.attr)
    return reg


# ---------------------------------------------------------------------
# pass 2: per-function walk with a held-lock stack
# ---------------------------------------------------------------------

def _has_timeout(call: ast.Call, pos: int) -> bool:
    """Does ``call`` bound its blocking (positional arg #pos onward or a
    timeout= keyword)?"""
    if len(call.args) > pos:
        return True
    return any(kw.arg == "timeout" for kw in call.keywords)


def _nonblocking(call: ast.Call) -> bool:
    """queue get/put with block=False / get_nowait-style bound."""
    if call.args and isinstance(call.args[0], ast.Constant) \
            and call.args[0].value is False:
        return True
    for kw in call.keywords:
        if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
        if kw.arg == "timeout":
            return True
    return False


class _FuncWalker:
    """Walks one function body tracking the with-held lock stack."""

    def __init__(self, reg: _Registry, rel: str, cls: Optional[str],
                 qual: str, findings: List[Finding],
                 edges: List[OrderEdge],
                 containers: Set[str] = frozenset()):
        self.reg = reg
        self.rel = rel
        self.containers = containers
        self.cls = cls
        self.qual = qual
        self.findings = findings
        self.edges = edges
        self.held: List[str] = []
        self.info = _FuncInfo(qual=qual, file=rel, cls=cls)
        self.finally_released: Set[str] = set()

    # -- entry --------------------------------------------------------
    def run(self, fn: ast.AST) -> _FuncInfo:
        self._scan_finally_releases(fn)
        for stmt in fn.body:
            self._stmt(stmt)
        return self.info

    def _scan_finally_releases(self, fn: ast.AST) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try):
                continue
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr == "release":
                        lid = self.reg.resolve(sub.func.value, self.cls)
                        if lid:
                            self.finally_released.add(lid)

    # -- statement dispatch (keeps held-stack scoping for With) -------
    def _stmt(self, stmt: ast.AST) -> None:
        if isinstance(stmt, ast.With) or isinstance(stmt, ast.AsyncWith):
            pushed = []
            for item in stmt.items:
                self._expr(item.context_expr)
                lid = self.reg.resolve(item.context_expr, self.cls)
                if lid is None and isinstance(item.context_expr, ast.Call):
                    # with self._lock: is an expr; with cv: too — but
                    # `with self._pool.lease() as ...:` is a call; try
                    # resolving the receiver of zero-arg acquire-ish
                    # calls is out of scope.
                    lid = None
                if lid:
                    self._acquire(lid, stmt.lineno)
                    pushed.append(lid)
            for inner in stmt.body:
                self._stmt(inner)
            for lid in reversed(pushed):
                self.held.remove(lid)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs analyzed separately (no held context)
        # Recurse into compound statements, visiting expressions.
        for field in ast.iter_child_nodes(stmt):
            if isinstance(field, ast.stmt):
                self._stmt(field)
            else:
                self._expr(field)

    # -- expression walk ---------------------------------------------
    def _expr(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub)

    def _acquire(self, lid: str, line: int) -> None:
        for outer in self.held:
            if outer != lid:
                self.edges.append(OrderEdge(
                    outer=outer, inner=lid, file=self.rel,
                    func=self.qual, line=line))
        self.held.append(lid)
        self.info.acquires.add(lid)

    def _call(self, call: ast.Call) -> None:
        f = call.func
        attr = f.attr if isinstance(f, ast.Attribute) else None
        name = f.id if isinstance(f, ast.Name) else None

        # .acquire() outside with / try-finally
        if attr == "acquire":
            lid = self.reg.resolve(f.value, self.cls)
            if lid:
                self.info.acquires.add(lid)
                for outer in self.held:
                    if outer != lid:
                        self.edges.append(OrderEdge(
                            outer=outer, inner=lid, file=self.rel,
                            func=self.qual, line=call.lineno))
                if lid not in self.finally_released:
                    self.findings.append(Finding(
                        kind="bare_acquire", file=self.rel,
                        func=self.qual, detail=lid, line=call.lineno,
                        message=f"{lid}.acquire() with no try/finally "
                                f"release and not in a with-block"))
            return

        # blocking ops while holding a known lock
        if self.held:
            blocked = None
            if attr in ("wait", "wait_for") \
                    and not _has_timeout(call, 0 if attr == "wait" else 1):
                lid = self.reg.resolve(f.value, self.cls)
                target = lid or attr
                blocked = f"wait@{target}"
            elif attr == "join" and not call.args and not call.keywords \
                    and not isinstance(f.value, ast.Constant):
                blocked = "join"
            elif attr in ("get", "put") and isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Attribute) \
                    and f.value.attr in self.reg.queue_attrs \
                    and not _nonblocking(call):
                blocked = f"queue.{attr}@{f.value.attr}"
            elif attr == "call":
                blocked = "rpc.call"
            elif attr == "sleep" and isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and f.value.id == "time":
                blocked = "time.sleep"
            if blocked:
                self.findings.append(Finding(
                    kind="blocking_under_lock", file=self.rel,
                    func=self.qual,
                    detail=f"{blocked}|held={self.held[-1]}",
                    line=call.lineno,
                    message=f"{blocked} while holding "
                            f"{' -> '.join(self.held)}"))

        # record the call for inter-procedural propagation
        token = None
        if name:
            token = f"func:{name}"
        elif attr and isinstance(f, ast.Attribute):
            recv = f.value
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls") \
                    and self.cls:
                token = f"method:{self.cls}.{attr}"
            elif isinstance(recv, ast.Name) and recv.id in self.containers:
                # A method of a module's own set/dict/list (``_edges.add``)
                # is a builtin's, never a class's of the same name.
                token = None
            else:
                token = f"anymethod:{attr}"
        if token and self.held:
            self.info.calls.append(
                (token, tuple(self.held), call.lineno))
        elif token:
            self.info.calls.append((token, (), call.lineno))


# ---------------------------------------------------------------------
# inter-procedural propagation + inversion detection
# ---------------------------------------------------------------------

def _index_functions(infos: List[_FuncInfo]
                     ) -> Dict[str, List[_FuncInfo]]:
    idx: Dict[str, List[_FuncInfo]] = {}
    for fi in infos:
        if "." in fi.qual:
            cls, meth = fi.qual.rsplit(".", 1)
            idx.setdefault(f"method:{cls}.{meth}", []).append(fi)
            idx.setdefault(f"anymethod:{meth}", []).append(fi)
        else:
            idx.setdefault(f"func:{fi.qual}", []).append(fi)
    return idx


def _resolve_call(token: str, idx: Dict[str, List[_FuncInfo]]
                  ) -> Optional[_FuncInfo]:
    cands = idx.get(token, [])
    if token.startswith("anymethod:"):
        # Only resolve attribute calls on unknown receivers when the
        # method name is unambiguous across the corpus.
        uniq = {fi.qual for fi in cands}
        return cands[0] if len(uniq) == 1 else None
    return cands[0] if len(cands) == 1 else None


def _propagate(infos: List[_FuncInfo], edges: List[OrderEdge]) -> None:
    """Fixed point of trans_acquires, then emit held x callee-acquires
    order edges."""
    idx = _index_functions(infos)
    for fi in infos:
        fi.trans_acquires = set(fi.acquires)
    changed = True
    iters = 0
    while changed and iters < 50:
        changed = False
        iters += 1
        for fi in infos:
            for token, _held, _line in fi.calls:
                callee = _resolve_call(token, idx)
                if callee is None:
                    continue
                new = callee.trans_acquires - fi.trans_acquires
                if new:
                    fi.trans_acquires |= new
                    changed = True
    for fi in infos:
        for token, held, line in fi.calls:
            if not held:
                continue
            callee = _resolve_call(token, idx)
            if callee is None:
                continue
            for inner in callee.trans_acquires:
                for outer in held:
                    if outer != inner:
                        edges.append(OrderEdge(
                            outer=outer, inner=inner, file=fi.file,
                            func=fi.qual, line=line,
                            via=f"via {callee.qual}()"))


def _sccs(adj: Dict[str, Set[str]]) -> List[List[str]]:
    """Kosaraju SCCs (graphs here have a handful of nodes)."""
    order: List[str] = []
    seen: Set[str] = set()
    nodes = sorted(set(adj) | {v for vs in adj.values() for v in vs})

    def dfs(start: str, graph: Dict[str, Set[str]], out: List[str],
            visited: Set[str]) -> None:
        stack = [(start, iter(sorted(graph.get(start, ()))))]
        visited.add(start)
        while stack:
            v, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                stack.pop()
                out.append(v)
            elif nxt not in visited:
                visited.add(nxt)
                stack.append((nxt, iter(sorted(graph.get(nxt, ())))))

    for v in nodes:
        if v not in seen:
            dfs(v, adj, order, seen)
    radj: Dict[str, Set[str]] = {}
    for u, vs in adj.items():
        for v in vs:
            radj.setdefault(v, set()).add(u)
    seen = set()
    comps: List[List[str]] = []
    for v in reversed(order):
        if v not in seen:
            comp: List[str] = []
            dfs(v, radj, comp, seen)
            comps.append(sorted(comp))
    return comps


def _inversions(edges: List[OrderEdge], findings: List[Finding]) -> None:
    adj: Dict[str, Set[str]] = {}
    site: Dict[Tuple[str, str], OrderEdge] = {}
    for e in edges:
        adj.setdefault(e.outer, set()).add(e.inner)
        site.setdefault((e.outer, e.inner), e)
    for comp in _sccs(adj):
        if len(comp) < 2:
            continue
        examples = []
        for a in comp:
            for b in comp:
                e = site.get((a, b))
                if e is not None:
                    examples.append(
                        f"{a} -> {b} at {e.file}:{e.line} "
                        f"({e.func}{' ' + e.via if e.via else ''})")
        rep = site.get((comp[0], comp[1])) or next(iter(site.values()))
        findings.append(Finding(
            kind="lock_inversion", file=rep.file, func=rep.func,
            detail="<->".join(comp), line=rep.line,
            message="lock-order inversion among {" + ", ".join(comp)
                    + "}: " + "; ".join(examples)))


# ---------------------------------------------------------------------
# allowlist (minimal TOML subset: [[allow]] tables of string pairs —
# python 3.10 has no tomllib and the image bans new deps)
# ---------------------------------------------------------------------

def load_allowlist(path: str) -> List[Dict[str, str]]:
    entries: List[Dict[str, str]] = []
    cur: Optional[Dict[str, str]] = None
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return entries
    for ln, raw in enumerate(lines, 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[allow]]":
            cur = {}
            entries.append(cur)
            continue
        if "=" in line and cur is not None:
            k, _, v = line.partition("=")
            k, v = k.strip(), v.strip()
            if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
                cur[k] = v[1:-1]
                continue
        raise ValueError(
            f"{path}:{ln}: expected '[[allow]]' or 'key = \"...\"', "
            f"got: {line!r}")
    for i, e in enumerate(entries):
        if "key" not in e or not e.get("reason"):
            raise ValueError(
                f"{path}: allow entry #{i + 1} needs both key and a "
                f"non-empty reason (one-line justification)")
    return entries


def is_allowed(finding: Finding,
               allowlist: Sequence[Dict[str, str]]) -> bool:
    return any(fnmatch.fnmatchcase(finding.key, e["key"])
               for e in allowlist)


# ---------------------------------------------------------------------
# the whole-package analysis
# ---------------------------------------------------------------------

@dataclasses.dataclass
class LockdepReport:
    locks: List[str]
    edges: List[OrderEdge]
    findings: List[Finding]
    files_scanned: int

    def static_edges(self) -> Set[Tuple[str, str]]:
        return {(e.outer, e.inner) for e in self.edges}


_CONTAINER_CTORS = {"set", "dict", "list", "OrderedDict", "defaultdict"}


def _module_containers(tree: ast.Module) -> Set[str]:
    """Module-level names bound to a builtin container
    (``_edges: Set[...] = set()``, ``_cache = {}``)."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            tgt, value = node.target, node.value
        else:
            continue
        if not isinstance(tgt, ast.Name):
            continue
        if isinstance(value, (ast.Set, ast.Dict, ast.List)) or (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Name)
                and value.func.id in _CONTAINER_CTORS):
            out.add(tgt.id)
    return out


def _uses_threading(tree: ast.Module, package: str) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.split(".")[0] in ("threading", "queue")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            mod = (node.module or "").split(".")[0]
            if mod in ("threading", "queue"):
                return True
            if mod == package or (node.module or "").startswith(
                    package):
                if any(a.name in LOCK_FACTORIES for a in node.names):
                    return True
    return False


def analyze(root: str, package: str = "tepdist_tpu_torch"
            ) -> LockdepReport:
    """Run the full lint over ``root/package`` and return the report
    (findings NOT yet filtered by any allowlist)."""
    modules: Dict[str, ast.Module] = {}
    pkg_dir = os.path.join(root, package)
    for dirpath, _dirs, files in os.walk(pkg_dir):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            with open(path) as f:
                src = f.read()
            tree = ast.parse(src, filename=rel)
            if _uses_threading(tree, package):
                modules[rel] = tree
    reg = _collect_registry(modules)
    findings: List[Finding] = []
    edges: List[OrderEdge] = []
    infos: List[_FuncInfo] = []
    for rel, tree in modules.items():
        containers = _module_containers(tree)
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                w = _FuncWalker(reg, rel, None, node.name, findings,
                                edges, containers)
                infos.append(w.run(node))
            elif isinstance(node, ast.ClassDef):
                for meth in node.body:
                    if isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        w = _FuncWalker(reg, rel, node.name,
                                        f"{node.name}.{meth.name}",
                                        findings, edges, containers)
                        infos.append(w.run(meth))
    _propagate(infos, edges)
    _inversions(edges, findings)
    findings.sort(key=lambda f: (f.kind, f.file, f.line))
    return LockdepReport(locks=sorted(reg.locks), edges=edges,
                         findings=findings, files_scanned=len(modules))
