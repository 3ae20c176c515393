"""Concurrency rules JL019-JL021: lock order, shared state, lock-held blocking
(the JAX package's ``analysis/concurrency.py``: the same index, fixed
point and scope limits; JL021 also knows torch's blocking calls).

The pattern rules in :mod:`.rules` look at one function at a time; this
pass is the interprocedural counterpart for the hazard class that bites
threaded serving code (trial-token leaks, post-abort double counting,
flush-vs-enqueue).  It runs in two phases:

**Phase 1 — index.**  Per module, per class: which ``self`` attributes
hold locks (``threading.Lock/RLock/Condition`` or the lockwatch
``make_lock`` factory, assigned in a method or the class body), which
methods start threads (``threading.Thread(target=self.m)``) or are
worker loops by name (``run``/``_run``/``*_loop``/``*_worker``/
``*_main``), and — per method, tracking the ``with self._lock:``
nesting — every lock acquisition, every ``self.attr`` read/write with
the locks held at that point, every blocking call, and every
``self.m()`` call with the locks held at the call site.

**Phase 2 — rules**, evaluated over a fixed point that propagates
held-lock sets through same-class calls (a helper only ever called
under the lock IS guarded; one called both ways is analyzed both ways):

- **JL019** (error) — the per-class lock-acquisition graph (edge A→B =
  B acquired while A held, transitively through self-calls) has a
  cycle: two threads can interleave the opposite orders into a
  deadlock.
- **JL020** (warning) — an attribute is written under a lock in one
  method but read or written lock-free in another, and the two methods
  are reachable from different thread entry points (worker loops count;
  so do external callers, who may be N server threads).  The guarded
  write declares the attribute shared; the lock-free access is either a
  bug or a deliberate benign race that must carry a waiver saying why.
- **JL021** (warning) — a blocking call while holding a lock:
  ``.launch(...)`` (a device dispatch), ``sleep``, ``urlopen`` /
  ``socket.create_connection``, a zero-positional-arg ``.get()``
  (queue-style blocking read; ``dict.get`` always has a key argument)
  or ``.join()`` (thread join; ``str.join`` always has an iterable),
  and ``.wait()`` on anything that is not the held condition itself;
  and torch's host-device syncs: ``torch.cuda.synchronize()`` or
  ``.synchronize()`` on a stream or event, and a zero-argument
  ``.item()`` / ``.cpu()`` / ``.numpy()`` / ``.tolist()`` (a tensor read
  back to the host waits for every kernel queued before it).
  Holding a lock across any of these serializes every thread that
  touches the lock behind a device, a socket, or a sleep.

Scope boundaries: analysis is per class —
module-level locks, locks passed in as constructor arguments, and
cross-class holds (A's method, holding A's lock, calls B which takes
B's lock) are invisible here; the runtime witness
(analysis/lockwatch.py) covers the cross-class case on real
executions.  ``lock.acquire()``/``release()`` call pairs are not
tracked (only ``with`` regions); container mutation through a method
call (``self._q.append(...)``) indexes as a read.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterator

from .engine import Finding, ModuleContext, Rule, Severity
from .lockwatch import find_cycles
from .rules import dotted_name

# Entry-point label for "any outside caller" — the public surface may be
# driven by N threads at once (HTTP handlers, test drivers).
EXTERNAL = "<caller>"

_LOCK_CTOR_TAILS = {"Lock", "RLock", "Condition", "make_lock"}
_WORKER_NAME_SUFFIXES = ("_loop", "_worker", "_main")
_HOST_READ_TAILS = ("item", "cpu", "numpy", "tolist")


def _is_lock_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    name = dotted_name(value.func)
    return bool(name) and name.split(".")[-1] in _LOCK_CTOR_TAILS


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> ``"X"``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_worker_name(name: str) -> bool:
    return name in ("run", "_run") or name.endswith(_WORKER_NAME_SUFFIXES)


@dataclass
class Access:
    attr: str
    kind: str  # "read" | "write"
    held: tuple[str, ...]  # locks held locally at the access
    node: ast.AST


@dataclass
class Acquire:
    held: tuple[str, ...]  # locks already held locally at the with
    attr: str
    node: ast.AST


@dataclass
class Blocking:
    held: tuple[str, ...]
    label: str
    node: ast.AST


@dataclass
class SelfCall:
    held: tuple[str, ...]
    callee: str
    node: ast.AST


@dataclass
class MethodInfo:
    name: str
    node: ast.AST
    acquires: list[Acquire] = field(default_factory=list)
    accesses: list[Access] = field(default_factory=list)
    blocking: list[Blocking] = field(default_factory=list)
    calls: list[SelfCall] = field(default_factory=list)


@dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    locks: set[str] = field(default_factory=set)
    methods: dict[str, MethodInfo] = field(default_factory=dict)
    properties: set[str] = field(default_factory=set)
    # method name -> human label of the thread that runs it
    thread_roots: dict[str, str] = field(default_factory=dict)


class ConcurrencyIndex:
    """Phase 1: every class's locks, threads, and per-method region
    facts for one module.  Built once per file and cached on the
    ModuleContext (the get_trace_analysis pattern)."""

    def __init__(self, tree: ast.Module):
        self.classes: list[ClassInfo] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self.classes.append(self._index_class(node))

    # -- class indexing --------------------------------------------------------

    def _index_class(self, cls: ast.ClassDef) -> ClassInfo:
        info = ClassInfo(name=cls.name, node=cls)
        defs = [
            n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        # Locks: class-body assigns plus `self.X = Lock()` in any method.
        for stmt in cls.body:
            if (isinstance(stmt, ast.Assign)
                    and _is_lock_ctor(stmt.value)):
                for target in stmt.targets:
                    if isinstance(target, ast.Name):
                        info.locks.add(target.id)
        for fn in defs:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign) and _is_lock_ctor(sub.value):
                    for target in sub.targets:
                        attr = _self_attr(target)
                        if attr is not None:
                            info.locks.add(attr)
                # threading.Thread(target=self.m)
                if isinstance(sub, ast.Call):
                    name = dotted_name(sub.func) or ""
                    if name.split(".")[-1] == "Thread":
                        for kw in sub.keywords:
                            if kw.arg == "target":
                                attr = _self_attr(kw.value)
                                if attr is not None:
                                    info.thread_roots.setdefault(
                                        attr, f"thread target {attr}()"
                                    )
        method_names = set()
        for fn in defs:
            if fn.name in method_names:
                continue  # first def wins (overloads/ifdefs)
            method_names.add(fn.name)
            if any(
                dotted_name(d) in ("property", "functools.cached_property",
                                   "cached_property")
                for d in fn.decorator_list
            ):
                info.properties.add(fn.name)
        # Worker-loop idiom: named like a loop body, in a lock-owning
        # class — the thread may be constructed by a collaborator.
        if info.locks:
            for fn in defs:
                if _is_worker_name(fn.name):
                    info.thread_roots.setdefault(
                        fn.name, f"worker loop {fn.name}()"
                    )
        for fn in defs:
            if fn.name not in info.methods:
                info.methods[fn.name] = self._scan_method(
                    fn, info.locks, method_names, info.properties
                )
        return info

    # -- method scanning -------------------------------------------------------

    def _scan_method(
        self,
        fn: ast.AST,
        locks: set[str],
        method_names: set[str],
        properties: set[str],
    ) -> MethodInfo:
        info = MethodInfo(name=fn.name, node=fn)

        def visit(node: ast.AST, held: tuple[str, ...]) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and attr in locks:
                        info.acquires.append(Acquire(inner, attr, node))
                        inner = inner + (attr,)
                    else:
                        visit(item.context_expr, inner)
                for stmt in node.body:
                    visit(stmt, inner)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                # A closure defined here runs later — usually on another
                # thread (completion hooks) — with NO lock held.
                body = node.body if isinstance(node.body, list) else [node.body]
                for stmt in body:
                    visit(stmt, ())
                return
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                if callee is not None and callee in method_names:
                    info.calls.append(SelfCall(held, callee, node))
                else:
                    label = self._blocking_label(node, held, locks)
                    if label is not None:
                        info.blocking.append(Blocking(held, label, node))
                for child in ast.iter_child_nodes(node):
                    visit(child, held)
                return
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for target in targets:
                    self._visit_store(target, held, info, locks,
                                      method_names, visit)
                if node.value is not None:
                    visit(node.value, held)
                return
            if isinstance(node, ast.Delete):
                for target in node.targets:
                    self._visit_store(target, held, info, locks,
                                      method_names, visit)
                return
            attr = _self_attr(node)
            if attr is not None:
                if attr in properties:
                    info.calls.append(SelfCall(held, attr, node))
                elif attr not in locks and attr not in method_names:
                    kind = ("write" if isinstance(
                        getattr(node, "ctx", ast.Load()),
                        (ast.Store, ast.Del)) else "read")
                    info.accesses.append(Access(attr, kind, held, node))
                return
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, ())
        return info

    @staticmethod
    def _visit_store(target, held, info: MethodInfo, locks, method_names,
                     visit) -> None:
        """An assignment/delete target: ``self.x`` and ``self.x[k]``
        both count as writes to ``x``; anything else recurses."""
        attr = _self_attr(target)
        if attr is None and isinstance(target, ast.Subscript):
            attr = _self_attr(target.value)
            if attr is not None:
                visit(target.slice, held)
        if attr is not None:
            if attr not in locks and attr not in method_names:
                info.accesses.append(Access(attr, "write", held, target))
            return
        for child in ast.iter_child_nodes(target):
            visit(child, held)

    @staticmethod
    def _blocking_label(call: ast.Call, held: tuple[str, ...],
                        locks: set[str]) -> str | None:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in ("sleep", "urlopen"):
                return f"{func.id}()"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        tail = func.attr
        if tail == "launch":
            return "engine dispatch .launch()"
        if tail == "sleep":
            return "sleep()"
        if tail == "urlopen":
            return "urlopen()"
        if tail == "create_connection":
            return "socket create_connection()"
        if tail == "get" and not call.args:
            # Zero positional args = queue-style blocking read
            # (dict.get always takes the key).
            return "queue-style blocking .get()"
        if tail == "join" and not call.args:
            # str.join always takes the iterable; a bare .join() is a
            # thread/process join.
            return "thread .join()"
        if tail == "synchronize":
            return "device .synchronize()"
        if tail in _HOST_READ_TAILS and not call.args and not call.keywords:
            # A tensor read back to the host waits for the device.
            return f"host read .{tail}()"
        if tail in ("wait", "wait_for"):
            recv = _self_attr(func.value)
            if recv is not None and recv in locks:
                # Condition.wait on the held condition RELEASES it —
                # that is the one sanctioned block-while-holding.
                return None
            return f"event/future .{tail}()"
        return None


def get_concurrency_index(ctx: ModuleContext) -> ConcurrencyIndex:
    index = getattr(ctx, "_concurrency_index", None)
    if index is None:
        index = ConcurrencyIndex(ctx.tree)
        ctx._concurrency_index = index
    return index


# ---------------------------------------------------------------------------
# phase 2 shared machinery


def _entry_contexts(cls: ClassInfo) -> dict[str, set[frozenset[str]]]:
    """Fixed point of held-lock sets each method can be entered with.

    Seeds: the empty set for every method that is externally callable —
    thread roots, public names, dunders, and methods never referenced
    from inside the class (callbacks).  A private helper only reached
    via ``with self._lock: self._helper()`` gets ONLY the {lock}
    context, which is exactly what makes it guarded."""
    referenced = {
        call.callee for m in cls.methods.values() for call in m.calls
    }
    ctxs: dict[str, set[frozenset[str]]] = {m: set() for m in cls.methods}
    work: list[tuple[str, frozenset[str]]] = []

    def add(method: str, held: frozenset) -> None:
        if method in ctxs and held not in ctxs[method]:
            ctxs[method].add(held)
            work.append((method, held))

    for name in cls.methods:
        externally_callable = (
            name in cls.thread_roots
            or not name.startswith("_")
            or (name.startswith("__") and name.endswith("__"))
            or name not in referenced
        )
        if externally_callable:
            add(name, frozenset())
    while work:
        name, held = work.pop()
        info = cls.methods[name]
        local_ctx = held
        for call in info.calls:
            add(call.callee, frozenset(local_ctx | set(call.held)))
    return ctxs


def _reachability(cls: ClassInfo) -> dict[str, set[str]]:
    """Method -> set of entry-point labels whose threads can reach it.

    Thread roots are their own label; everything public (minus
    ``__init__`` — construction precedes sharing) is additionally
    reachable from EXTERNAL."""
    adj: dict[str, set[str]] = {
        name: {c.callee for c in info.calls}
        for name, info in cls.methods.items()
    }

    def bfs(seeds: set[str]) -> set[str]:
        seen = set()
        frontier = [s for s in seeds if s in cls.methods]
        while frontier:
            name = frontier.pop()
            if name in seen:
                continue
            seen.add(name)
            frontier.extend(adj.get(name, ()))
        return seen

    roots: dict[str, set[str]] = {}
    for target, label in cls.thread_roots.items():
        roots[label] = bfs({target})
    public = {
        name for name in cls.methods
        if name != "__init__"
        and (not name.startswith("_")
             or (name.startswith("__") and name.endswith("__")))
    }
    roots[EXTERNAL] = bfs(public)
    out: dict[str, set[str]] = {name: set() for name in cls.methods}
    for label, reached in roots.items():
        for name in reached:
            out[name].add(label)
    return out


def _fmt_locks(locks) -> str:
    return " + ".join(f"self.{name}" for name in sorted(locks))


# ---------------------------------------------------------------------------
# JL019 — lock-order inversion


class LockOrderRule(Rule):
    """JL019: a class's methods acquire its locks in conflicting orders.

    The acquisition graph has an edge A→B when some method (or a helper
    it calls, transitively) enters ``with self.B:`` while ``self.A`` is
    held.  A cycle means thread 1 can hold A wanting B while thread 2
    holds B wanting A — a deadlock that no test run has to hit for the
    hazard to be real.  The fix is an ordering discipline (always A
    before B) or collapsing to one lock; the runtime witness
    (analysis/lockwatch.py) asserts the same property over observed
    cross-class orders in chaos CI.
    """

    rule_id = "JL019"
    severity = Severity.ERROR
    summary = "lock-order inversion: class acquires its locks in a cycle"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls in get_concurrency_index(ctx).classes:
            if len(cls.locks) < 2:
                continue
            ctxs = _entry_contexts(cls)
            # edge -> (example node, method name), earliest line wins
            edges: dict[tuple[str, str], tuple[ast.AST, str]] = {}
            for name, info in cls.methods.items():
                for held_ctx in ctxs[name]:
                    for acq in info.acquires:
                        for held in set(held_ctx) | set(acq.held):
                            if held == acq.attr:
                                continue
                            edge = (held, acq.attr)
                            prev = edges.get(edge)
                            if (prev is None
                                    or acq.node.lineno < prev[0].lineno):
                                edges[edge] = (acq.node, name)
            graph: dict[str, set[str]] = {}
            for (a, b) in edges:
                graph.setdefault(a, set()).add(b)
            for cycle in find_cycles(graph):
                hops = list(zip(cycle, cycle[1:]))
                details = ", ".join(
                    f"self.{a}->self.{b} in {edges[(a, b)][1]}() "
                    f"line {edges[(a, b)][0].lineno}"
                    for a, b in hops
                )
                anchor = max(
                    (edges[hop][0] for hop in hops), key=lambda n: n.lineno
                )
                yield self.finding(
                    ctx, anchor,
                    f"lock-order inversion in class {cls.name}: "
                    + " -> ".join(f"self.{s}" for s in cycle)
                    + f" ({details}); two threads taking these in "
                    "opposite orders deadlock — pick one global order "
                    "or collapse to a single lock",
                )


# ---------------------------------------------------------------------------
# JL020 — unguarded shared mutation


class SharedStateRule(Rule):
    """JL020: an attribute guarded in one method, bare in another.

    A write under ``with self._lock:`` declares the attribute shared
    mutable state; a lock-free read or write of the same attribute in a
    method reachable from a DIFFERENT thread entry point is then either
    a torn-read/lost-update bug or a deliberate benign race — and a
    deliberate race must say so in a waiver, because the next reader
    cannot tell it from the bug (PRs 8/11 fixed several that looked
    exactly like this).  ``__init__`` is exempt: construction happens
    before the object is shared.
    """

    rule_id = "JL020"
    severity = Severity.WARNING
    summary = "attribute written under a lock but accessed lock-free elsewhere"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls in get_concurrency_index(ctx).classes:
            # Owning a lock IS the declaration of concurrent use; the
            # class does not also have to construct its own threads
            # (breakers and caches are driven by their callers' threads).
            if not cls.locks:
                continue
            ctxs = _entry_contexts(cls)
            reach = _reachability(cls)
            guarded: dict[str, list[tuple[str, str, int]]] = {}
            bare: dict[str, list[tuple[str, str, ast.AST]]] = {}
            for name, info in cls.methods.items():
                if name == "__init__":
                    continue
                for held_ctx in ctxs[name]:
                    for acc in info.accesses:
                        eff = set(held_ctx) | set(acc.held)
                        if eff and acc.kind == "write":
                            guarded.setdefault(acc.attr, []).append(
                                (sorted(eff)[0], name, acc.node.lineno)
                            )
                        if not eff:
                            bare.setdefault(acc.attr, []).append(
                                (acc.kind, name, acc.node)
                            )
            for attr, writers in sorted(guarded.items()):
                accesses = bare.get(attr)
                if not accesses:
                    continue
                writers = sorted(set(writers), key=lambda w: w[2])
                seen_nodes: set[int] = set()
                for kind, method, node in accesses:
                    if id(node) in seen_nodes:
                        continue
                    seen_nodes.add(id(node))
                    hit = self._crossing(reach, writers, method)
                    if hit is None:
                        continue
                    lock, writer, root_a, root_b = hit
                    verb = "written" if kind == "write" else "read"
                    yield self.finding(
                        ctx, node,
                        f"'{attr}' is written under self.{lock} in "
                        f"{writer}() but {verb} lock-free in {method}() "
                        f"— concurrent from '{root_a}' vs '{root_b}'; "
                        "take the lock here, or waive with the reason "
                        "the race is benign",
                    )

    @staticmethod
    def _crossing(reach, writers, method):
        """First (lock, writer, rootA, rootB) where the guarded writer
        and the bare accessor can run on different threads; None when
        every path pins both to the same single thread."""
        acc_roots = reach.get(method, set())
        for lock, writer, _line in writers:
            w_roots = reach.get(writer, set())
            if not acc_roots or not w_roots:
                continue
            pair = None
            for r1 in sorted(w_roots):
                for r2 in sorted(acc_roots):
                    if r1 != r2 or r1 == EXTERNAL:
                        pair = (r1, r2)
                        break
                if pair:
                    break
            if pair:
                return lock, writer, pair[0], pair[1]
        return None


# ---------------------------------------------------------------------------
# JL021 — blocking call while holding a lock


class BlockingUnderLockRule(Rule):
    """JL021: device dispatch / socket / sleep / blocking-queue read
    inside a ``with``-lock region.

    Holding a lock across a blocking call turns every thread that ever
    touches that lock into a convoy behind the device or the network —
    the serving pipeline's whole design is that locks cover bookkeeping
    only and dispatch happens outside them.  ``Condition.wait`` on the
    held condition is exempt (it releases the lock while blocked).
    """

    rule_id = "JL021"
    severity = Severity.WARNING
    summary = "blocking call (launch/socket/sleep/queue-get/join) under a lock"

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for cls in get_concurrency_index(ctx).classes:
            if not cls.locks:
                continue
            ctxs = _entry_contexts(cls)
            seen_nodes: set[int] = set()
            for name, info in cls.methods.items():
                for held_ctx in sorted(ctxs[name], key=sorted):
                    for blk in info.blocking:
                        eff = set(held_ctx) | set(blk.held)
                        if not eff or id(blk.node) in seen_nodes:
                            continue
                        seen_nodes.add(id(blk.node))
                        via = (
                            "" if blk.held
                            else " (lock held by a caller of this helper)"
                        )
                        yield self.finding(
                            ctx, blk.node,
                            f"blocking {blk.label} in {cls.name}."
                            f"{name}() while holding "
                            f"{_fmt_locks(eff)}{via}; every thread "
                            "touching the lock now waits on this call "
                            "— move it outside the region or waive "
                            "with the reason it is bounded",
                        )


CONCURRENCY_RULES = (
    LockOrderRule(),
    SharedStateRule(),
    BlockingUnderLockRule(),
)

concurrency_rule_by_id = {rule.rule_id: rule for rule in CONCURRENCY_RULES}
