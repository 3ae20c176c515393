"""The port's pattern rules: JL009, JL011-JL018 and JL022-JL024 (the JAX
package's ``analysis/rules.py``, with its rule ids, severities and
messages, read over torch code).  JL019-JL021, the concurrency pass, live
in :mod:`.concurrency`.

Every rule is a heuristic over one module's AST — no type inference, no
cross-file call graph.  Where the JAX rules find a dispatch through
``jax.jit`` values, these find it through *launch targets*
(:func:`is_launch_value`, :func:`is_launch_call`): the one resolution
JL009, JL011, JL013 and JL016 share.

False positives are expected at the margin; the contract is that they are
cheap to waive (``# jaxlint: disable=RULE -- reason``) and the waiver is
visible in review.

Not ported, and why:

- JL001-JL008: ``jax.random`` key reuse (JL001), work under a jax trace
  (JL002-JL004, JL007, JL008), buffer donation (JL005) and
  ``jax.device_get`` in a loop (JL006).  The port traces nothing, draws
  from ``torch.Generator`` objects and donates no buffer.
- JL010, the serial warmup ladder: the port's rungs compile no program;
  ``ops/_build.py`` builds each kernel library once a process, so a
  warmup loop has nothing to compile serially.
- ``sentinel.py``, the recompile sentinel: the compile firewall
  (``compile/service.py`` counts Programs built on a request's path and
  kernel libraries built or loaded after warmup) takes its place.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .engine import Finding, ModuleContext, Rule, Severity

# ---------------------------------------------------------------------------
# Shared AST helpers


def dotted_name(node: ast.AST) -> str | None:
    """``torch.cuda.synchronize`` for an Attribute chain rooted at a Name,
    else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last(name: str | None) -> str:
    return (name or "").rsplit(".", 1)[-1]


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def iter_own_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a def/lambda body WITHOUT descending into nested scopes."""
    if isinstance(fn, ast.Lambda):
        stack: list[ast.AST] = [fn.body]
    else:
        stack = list(getattr(fn, "body", []))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _SCOPE_NODES):
            stack.extend(ast.iter_child_nodes(node))


def iter_loop_body_nodes(loop: ast.AST) -> Iterator[ast.AST]:
    """Nodes executed by a loop's body, not descending into nested scopes.

    A function merely *defined* inside the loop runs elsewhere — flagging
    its body as per-iteration work would be a false positive.
    """
    stack: list[ast.AST] = list(loop.body) + list(loop.orelse)
    while stack:
        node = stack.pop()
        if isinstance(node, _SCOPE_NODES):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def iter_scope_nodes(scope: ast.AST) -> list[ast.AST]:
    """All nodes of one scope, not descending into nested scopes: a
    module's top-level statements flattened (so ``if __name__`` guards
    and try/except import shims are transparent), or a def/lambda body
    via :func:`iter_own_body`."""
    if isinstance(scope, ast.Module):
        nodes: list[ast.AST] = []
        stack: list[ast.AST] = list(scope.body)
        while stack:
            node = stack.pop()
            nodes.append(node)
            if not isinstance(node, _SCOPE_NODES):
                stack.extend(ast.iter_child_nodes(node))
        return nodes
    return list(iter_own_body(scope))


def _scopes(tree: ast.Module) -> list[ast.AST]:
    return [tree] + [
        d for d in ast.walk(tree)
        if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]


# ---------------------------------------------------------------------------
# Launch targets: the single source of truth for "this call runs device work"


# Constructors whose value is launched later: a startup Program
# (compile/program.py, whose .build() runs the warm step), a CUDA graph
# (its .replay()), and the sharded forward builder (serving/sharded.py).
_LAUNCH_CTOR_TAILS = {"Program", "CUDAGraph", "build_predict_fn"}
_LAUNCH_CTOR_NAMES = {"torch.compile"}
# Methods that run a launch target bound to a name or attribute.
_LAUNCH_METHODS = {"replay", "build"}
# The port's hand-written kernel wrappers (ops/): a call launches a kernel.
_KERNEL_WRAPPERS = {
    "fused_int8_head", "fused_adadelta_flat", "adadelta_delta_flat",
    "flash_attention", "flash_partial",
}


def is_launch_value(value: ast.AST) -> bool:
    """Is this expression a launch target?  True for ``Program(...)``,
    ``torch.cuda.CUDAGraph()``, ``torch.compile(...)``, a ``make_*_step``
    builder (serving/predict.py, parallel/ddp.py and the sharded
    variants) and ``sharded.build_predict_fn(...)``.

    The single source of truth for "is this name/attr a launch target" —
    JL009/JL011/JL013/JL016 all resolve through here."""
    if not isinstance(value, ast.Call):
        return False
    name = dotted_name(value.func)
    if not name:
        return False
    if name in _LAUNCH_CTOR_NAMES:
        return True
    last = _last(name)
    return last in _LAUNCH_CTOR_TAILS or (
        last.startswith("make_") and last.endswith("_step")
    )


def module_launch_names(tree: ast.Module) -> set[str]:
    """Module-level names bound to launch targets — visible inside every
    function (the ``predict = make_predict_step()`` -> ``def serve(...)``
    shape)."""
    out: set[str] = set()
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and is_launch_value(node.value)):
            out.add(node.targets[0].id)
    return out


def launch_attr_names(tree: ast.Module) -> set[str]:
    """Attribute names bound to launch targets anywhere in the module
    (``self._predict = make_predict_step(...)``)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and is_launch_value(node.value):
            for target in node.targets:
                if isinstance(target, ast.Attribute):
                    out.add(target.attr)
    return out


def scope_launch_names(scope: ast.AST, module_names: set[str]) -> set[str]:
    """``module_names`` plus the names one scope binds to launch targets."""
    names = set(module_names)
    for node in iter_scope_nodes(scope):
        if (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and is_launch_value(node.value)):
            names.add(node.targets[0].id)
    return names


def _is_target(node: ast.AST, names: set[str], attrs: set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in names
    return isinstance(node, ast.Attribute) and node.attr in attrs


def is_launch_call(node: ast.AST, names: set[str], attrs: set[str]) -> bool:
    """Does this Call launch device work?  A call of a known launch-target
    name or attr, ``.replay()``/``.build()`` on one, a kernel wrapper, or
    any ``*.launch(...)`` (the engine's dispatch)."""
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if _is_target(func, names, attrs):
        return True
    if isinstance(func, ast.Attribute):
        if func.attr == "launch":
            return True
        if func.attr in _LAUNCH_METHODS and _is_target(func.value, names, attrs):
            return True
    return _last(dotted_name(func)) in _KERNEL_WRAPPERS


def loops_with_launch_names(tree: ast.Module) -> Iterator[tuple[ast.AST, set[str]]]:
    """Every loop of the module, with the launch-target names visible in
    its scope (the module's and its own function's)."""
    module_names = module_launch_names(tree)
    for scope in _scopes(tree):
        names = scope_launch_names(scope, module_names)
        for node in iter_scope_nodes(scope):
            if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                yield node, names


def _is_bounded_for(loop: ast.AST) -> bool:
    """A ``for`` over a literal ``range(...)``: the bounded-retry idiom."""
    return (
        isinstance(loop, ast.For)
        and isinstance(loop.iter, ast.Call)
        and dotted_name(loop.iter.func) in {"range", "builtins.range"}
    )


# ---------------------------------------------------------------------------
# JL009 — blocking host reads of launch outputs inside dispatch loops


_NP_HOST_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
# ``.wait()`` is the port's own read-back of a launched batch
# (serving/engine.py DeviceResult): it synchronizes the batch's event.
_HOST_READ_METHODS = {"item", "cpu", "numpy", "tolist", "wait"}


class BlockingReadLoopRule(Rule):
    """JL009: ``.item()`` / ``.cpu()`` / ``.numpy()`` / ``.tolist()`` /
    ``np.asarray`` (or the engine's ``DeviceResult.wait()``) on a launch
    target's output, or a synchronize, inside the loop that dispatched it.

    A dispatch loop that launches the forward and immediately reads the
    result back serializes the whole chain — device compute, host
    padding, H2D and D2H never overlap, because CUDA's asynchronous
    launch is thrown away one call later by the blocking read.  The fix
    is to decouple completion from dispatch: launch inside the loop, hand
    the device tensor to a completion worker (or read once after the
    loop) so batch N+1's host work overlaps batch N's compute — the
    pipelined batcher's whole design.  A deliberate same-iteration read
    (a serial path, a benchmark timing one dispatch) is waived inline
    with a reason.

    Heuristics (per scope, as every rule resolves launch targets): an
    expression is a "launch output" when it
    calls a launch target (:func:`is_launch_call`) or names a variable
    assigned from one *inside the same loop body* (a handle produced
    before the loop is prefetched, not pipelined-away).  A
    ``torch.cuda.synchronize()`` or ``.synchronize()`` on a stream or
    event fires in any loop body that also launches: it waits for every
    kernel the iteration queued.
    """

    rule_id = "JL009"
    severity = Severity.WARNING
    summary = "blocking host read of a launch output inside its dispatch loop"

    @classmethod
    def _taint(cls, node: ast.AST, names, attrs, out_names) -> bool:
        """Does ``node`` lexically contain a launch call or a loop-local
        name bound from one?"""
        if is_launch_call(node, names, attrs):
            return True
        if isinstance(node, ast.Name) and node.id in out_names:
            return True
        return any(
            cls._taint(child, names, attrs, out_names)
            for child in ast.iter_child_nodes(node)
        )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        attrs = launch_attr_names(ctx.tree)
        for loop, names in loops_with_launch_names(ctx.tree):
            yield from self._check_loop(ctx, loop, names, attrs)

    def _check_loop(self, ctx, loop, names, attrs) -> Iterator[Finding]:
        body = list(iter_loop_body_nodes(loop))
        out_names: set[str] = set()
        for node in body:
            if (isinstance(node, ast.Assign)
                    and is_launch_call(node.value, names, attrs)):
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        out_names.add(target.id)
        launches = any(is_launch_call(n, names, attrs) for n in body)
        # ``x.cpu().numpy()`` is one read: report the outermost call only.
        inner: set[int] = set()
        for node in body:
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_READ_METHODS):
                inner.add(id(node.func.value))
        for node in body:
            if not isinstance(node, ast.Call) or id(node) in inner:
                continue
            name = dotted_name(node.func)
            func = node.func
            if name in _NP_HOST_CALLS:
                if any(self._taint(a, names, attrs, out_names)
                       for a in node.args):
                    yield self.finding(
                        ctx, node,
                        f"{name}(...) on a launch output inside its dispatch "
                        "loop blocks the loop on device compute + D2H every "
                        "iteration — asynchronous launch is wasted; hand the "
                        "device tensor to a completion worker or read after "
                        "the loop (serving/batcher.py)",
                    )
            elif (isinstance(func, ast.Attribute)
                    and func.attr in _HOST_READ_METHODS
                    and not node.args and not node.keywords
                    and self._taint(func.value, names, attrs, out_names)):
                yield self.finding(
                    ctx, node,
                    f".{func.attr}() on a launch output inside its dispatch "
                    "loop blocks the loop on device compute + D2H every "
                    "iteration — asynchronous launch is wasted; hand the "
                    "device tensor to a completion worker or read after "
                    "the loop (serving/batcher.py)",
                )
            elif (isinstance(func, ast.Attribute)
                    and func.attr == "synchronize" and launches):
                yield self.finding(
                    ctx, node,
                    ".synchronize() inside a dispatch loop serializes the "
                    "pipeline every iteration; bound in-flight work with a "
                    "window and complete asynchronously instead "
                    "(serving/batcher.py)",
                )


# ---------------------------------------------------------------------------
# JL011 — host-blocking data feeds between launched step calls


_FEED_CALLS = {"next"} | _NP_HOST_CALLS


class HostBlockingFeedRule(Rule):
    """JL011: the next batch materialized on the critical path between
    two launched step calls, with no prefetch wrapper in scope.

    A training loop shaped ``x = np.asarray(next(it)); state = step(x)``
    pays the whole assemble + H2D cost INSIDE the gap between step k's
    launch and step k+1's — the device idles exactly that long every
    iteration.  The fix is a prefetch wrapper (data/prefetch.py, or the
    loader's epoch iterator which wraps it): batch k+1 assembles and
    starts its copy on a background thread while step k runs.

    Heuristics (per scope, launch targets resolved as in JL009): a loop
    iteration is a *blocking feed* when its body (a) calls a launch
    target AND (b) materializes host data via ``next(...)`` or
    ``np.asarray``/``np.array`` whose result flows into that call's
    arguments — directly, or through a name assigned in the same loop
    body.  Feeds whose source expression mentions a prefetch wrapper (any
    name containing ``prefetch``) are exempt.  A deliberately serial feed
    (a benchmark timing the end-to-end chain) is waived inline with a
    reason.
    """

    rule_id = "JL011"
    severity = Severity.WARNING
    summary = "host-blocking data feed between launched step calls; prefetch it"

    @staticmethod
    def _mentions_prefetch(node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Name) and "prefetch" in sub.id.lower():
                return True
            if isinstance(sub, ast.Attribute) and "prefetch" in sub.attr.lower():
                return True
        return False

    @classmethod
    def _feed_call(cls, node: ast.AST) -> ast.Call | None:
        """The first next()/np.asarray materialization inside ``node``,
        skipping prefetch-wrapped sources."""
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name in _FEED_CALLS and not cls._mentions_prefetch(node):
                return node
        for child in ast.iter_child_nodes(node):
            hit = cls._feed_call(child)
            if hit is not None:
                return hit
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        attrs = launch_attr_names(ctx.tree)
        for loop, names in loops_with_launch_names(ctx.tree):
            yield from self._check_loop(ctx, loop, names, attrs)

    def _check_loop(self, ctx, loop, names, attrs) -> Iterator[Finding]:
        body = sorted(
            iter_loop_body_nodes(loop),
            key=lambda n: (getattr(n, "lineno", 0), getattr(n, "col_offset", 0)),
        )
        calls = [n for n in body if is_launch_call(n, names, attrs)]
        if not calls:
            return
        feed_names: dict[str, ast.Call] = {}
        for node in body:
            if not isinstance(node, ast.Assign):
                continue
            feed = self._feed_call(node.value)
            if feed is None:
                continue
            for target in node.targets:
                for sub in ast.walk(target):
                    if isinstance(sub, ast.Name):
                        feed_names[sub.id] = feed
        reported: set[int] = set()
        for call in calls:
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                feed = self._feed_call(arg)
                if feed is None:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Name) and sub.id in feed_names:
                            feed = feed_names[sub.id]
                            break
                if feed is None:
                    continue
                anchor = getattr(feed, "lineno", 0)
                if anchor in reported:
                    continue
                reported.add(anchor)
                yield self.finding(
                    ctx, feed,
                    f"{dotted_name(feed.func)}(...) materializes the next "
                    "batch on the critical path between launched step calls: "
                    "the device idles through the whole assemble+transfer "
                    "every iteration; wrap the iterator in a prefetcher "
                    "(data/prefetch.py) so batch k+1 stages while step k "
                    "runs",
                )
                break


# ---------------------------------------------------------------------------
# JL012 — per-replica engine construction without shared warm state


_ENGINE_CTOR_TAIL = "InferenceEngine"
_ENGINE_FACTORY_METHODS = {"from_seed", "from_checkpoint"}
_ENGINE_SHARING_KWARGS = {"aot_cache", "mesh", "device", "devices"}


class EngineLoopRule(Rule):
    """JL012: an InferenceEngine built inside a loop without a shared
    kernel-library store or an explicit device pin.

    A loop that constructs one engine per device/replica warms one full
    bucket ladder per iteration.  Without ``aot_cache=`` (the shared
    ExecutableStore of kernel libraries, compile/aot.py) every replica
    may build its libraries with nvcc again, and without ``device=`` /
    ``devices=`` / ``mesh=`` every "replica" lands on the default card,
    so the loop multiplies startup cost without multiplying capacity.
    The fix is the pool idiom (serving/pool.py EnginePool).

    Heuristic: any loop-body call whose dotted name ends in
    ``InferenceEngine`` (or ``InferenceEngine.from_seed`` /
    ``.from_checkpoint``) with NONE of the sharing kwargs present.  A
    deliberately cache-less loop (a compile benchmark) is waived inline
    with a reason.
    """

    rule_id = "JL012"
    severity = Severity.WARNING
    summary = "per-loop InferenceEngine without shared AOT cache or device pin"

    @staticmethod
    def _engine_call(node: ast.AST) -> str | None:
        if not isinstance(node, ast.Call):
            return None
        name = dotted_name(node.func)
        if name is None:
            return None
        parts = name.split(".")
        if parts[-1] == _ENGINE_CTOR_TAIL:
            return name
        if (len(parts) >= 2
                and parts[-1] in _ENGINE_FACTORY_METHODS
                and parts[-2] == _ENGINE_CTOR_TAIL):
            return name
        return None

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for sub in iter_loop_body_nodes(loop):
                name = self._engine_call(sub)
                if name is None:
                    continue
                kwargs = {kw.arg for kw in sub.keywords if kw.arg}
                if kwargs & _ENGINE_SHARING_KWARGS:
                    continue
                yield self.finding(
                    ctx, sub,
                    f"{name}(...) constructed inside a loop with neither "
                    "a shared kernel-library store nor an explicit device "
                    "pin: each iteration warms a full bucket ladder (and "
                    "every replica lands on the default card); pass "
                    "aot_cache= (one shared ExecutableStore) and device= "
                    "per replica, or use the pool (serving/pool.py "
                    "EnginePool)",
                )


# ---------------------------------------------------------------------------
# JL013 — swallowed dispatch errors in an unbounded retry loop


_BROAD_EXCEPTS = {"Exception", "BaseException"}
_BACKOFF_HINTS = ("sleep", "backoff", "wait")


class SwallowedDispatchErrorRule(Rule):
    """JL013: a bare ``except:`` / ``except Exception`` swallowing errors
    around a launch (a launch target, a kernel wrapper or
    ``engine.launch``) inside an unbounded dispatch/retry loop — no
    re-raise, no bounded retry count, no backoff.

    A dispatch loop shaped ``while True: try: engine.launch(...) except
    Exception: continue`` turns a dead replica into an infinite hot loop
    that eats every request, counts nothing, heals nothing, and keeps the
    replica in rotation forever.  The sanctioned shapes surface the error
    to every waiter and keep serving under metrics (the batcher's
    dispatch worker), retry a BOUNDED number of times (``for attempt in
    range(n)``), or hand the replica to the supervisor.

    Heuristics: fires when (a) the loop is unbounded — any ``while``, or a
    ``for`` over something other than a literal ``range(...)``; (b) a
    ``try`` executed by the loop body contains a launch call
    (:func:`is_launch_call`); and (c) a catch-all handler contains none
    of ``raise`` / ``break`` / ``return`` and no call whose name mentions
    sleep/backoff/wait.  A deliberate swallow (a chaos driver, a
    best-effort prober) is waived inline with a reason.
    """

    rule_id = "JL013"
    severity = Severity.WARNING
    summary = "catch-all swallows dispatch errors in an unbounded retry loop"

    @staticmethod
    def _contains_dispatch(nodes: list[ast.AST], names, attrs) -> bool:
        stack = list(nodes)
        while stack:
            sub = stack.pop()
            if isinstance(sub, _SCOPE_NODES):
                continue
            if is_launch_call(sub, names, attrs):
                return True
            stack.extend(ast.iter_child_nodes(sub))
        return False

    @staticmethod
    def _handler_swallows(handler: ast.ExceptHandler) -> bool:
        if handler.type is not None:
            names = (
                [dotted_name(t) for t in handler.type.elts]
                if isinstance(handler.type, ast.Tuple)
                else [dotted_name(handler.type)]
            )
            last = {str(n).split(".")[-1] for n in names if n}
            if not last & _BROAD_EXCEPTS:
                return False
        stack: list[ast.AST] = list(handler.body)
        while stack:
            node = stack.pop()
            if isinstance(node, _SCOPE_NODES):
                continue
            if isinstance(node, (ast.Raise, ast.Break, ast.Return)):
                return False
            if isinstance(node, ast.Call):
                name = (dotted_name(node.func) or "").lower()
                if any(hint in name for hint in _BACKOFF_HINTS):
                    return False
            stack.extend(ast.iter_child_nodes(node))
        return True

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        attrs = launch_attr_names(ctx.tree)
        for loop, names in loops_with_launch_names(ctx.tree):
            if _is_bounded_for(loop):
                continue  # the bounded-retry idiom
            for node in iter_loop_body_nodes(loop):
                if not isinstance(node, ast.Try):
                    continue
                if not self._contains_dispatch(node.body, names, attrs):
                    continue
                for handler in node.handlers:
                    if self._handler_swallows(handler):
                        yield self.finding(
                            ctx, handler,
                            "catch-all around a device dispatch inside an "
                            "unbounded loop with no re-raise, bound, or "
                            "backoff: a dead replica becomes a silent "
                            "hot loop that poisons every request; surface "
                            "the error to its waiters and feed a failure "
                            "hook (serving/batcher.py), bound the retry "
                            "(for attempt in range(n)), or let the "
                            "supervisor quarantine the replica "
                            "(serving/pool.py)",
                        )


# ---------------------------------------------------------------------------
# JL014 — non-atomic / uncadenced checkpoint writes


# Raw writers and, for each, the index of the argument that names the
# DESTINATION (np.save(path, arr) vs torch.save(obj, path)).
_CKPT_WRITERS = {
    "np.save": 0, "numpy.save": 0,
    "np.savez": 0, "numpy.savez": 0,
    "np.savez_compressed": 0, "numpy.savez_compressed": 0,
    "torch.save": 1,
    "pickle.dump": 1,
}

# The port's atomic checkpoint helpers (utils/checkpoint.py).
_CKPT_HELPER_TAILS = {
    "save_train_state", "save_vit_train_state", "save_state_dict",
    "save_params_tree",
}

_CADENCE_GATE_CALLS = {"due", "should_checkpoint", "should_save"}
_CADENCE_NAME_HINTS = ("every", "interval", "cadence")


class CheckpointWriteRule(Rule):
    """JL014: a checkpoint write that is torn-file-unsafe or uncadenced.

    (a) **Atomicity**: a raw ``torch.save``/``np.savez``/``pickle.dump``
    straight onto its final path dies mid-write as a TORN file that the
    next load explodes on — every state write must route through
    utils/checkpoint.py's helpers (mkstemp + fsync + atomic replace).
    (b) **Cadence**: a save inside the step loop without a
    ``step % N``/``due(step)`` gate serializes a full host copy + disk
    write into EVERY step.

    Heuristics: (a) fires on a raw-writer call whose destination argument
    is a string constant, f-string, or ``os.path.join(...)`` call.  A Name
    destination stays silent (the atomic helpers write to temporaries and
    buffers).  (b) fires on any checkpoint write (raw writer or helper)
    executed by a loop body with no enclosing cadence-shaped If.  A
    deliberate bare write (a one-shot export script) is waived inline
    with a reason.
    """

    rule_id = "JL014"
    severity = Severity.WARNING
    summary = "checkpoint write bypasses the atomic helper or lacks a cadence guard"

    @staticmethod
    def _writer_call(node: ast.AST):
        """(dotted name, destination arg node) for a raw-writer call."""
        if not isinstance(node, ast.Call):
            return None
        name = dotted_name(node.func)
        if name is None:
            return None
        idx = _CKPT_WRITERS.get(name)
        if idx is None or len(node.args) <= idx:
            return None
        return name, node.args[idx]

    @staticmethod
    def _helper_call(node: ast.AST) -> str | None:
        if not isinstance(node, ast.Call):
            return None
        name = dotted_name(node.func)
        if name is None:
            return None
        return name if _last(name) in _CKPT_HELPER_TAILS else None

    @staticmethod
    def _is_direct_path(dest: ast.AST) -> bool:
        if isinstance(dest, ast.Constant) and isinstance(dest.value, str):
            return True
        if isinstance(dest, ast.JoinedStr):
            return True
        if isinstance(dest, ast.Call):
            return (dotted_name(dest.func) or "") in {"os.path.join", "path.join"}
        return False

    @classmethod
    def _is_cadence_test(cls, test: ast.AST) -> bool:
        for node in ast.walk(test):
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
                return True
            if isinstance(node, ast.Call):
                if _last(dotted_name(node.func)) in _CADENCE_GATE_CALLS:
                    return True
            if isinstance(node, (ast.Name, ast.Attribute)):
                label = (dotted_name(node) or "").lower()
                if any(h in label for h in _CADENCE_NAME_HINTS):
                    return True
        return False

    @classmethod
    def _unguarded_loop_nodes(cls, loop: ast.AST) -> Iterator[ast.AST]:
        stack: list[ast.AST] = list(loop.body) + list(loop.orelse)
        while stack:
            node = stack.pop()
            if isinstance(node, _SCOPE_NODES):
                continue
            if isinstance(node, ast.If) and cls._is_cadence_test(node.test):
                stack.extend(node.orelse)
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            hit = self._writer_call(node)
            if hit is None:
                continue
            name, dest = hit
            if self._is_direct_path(dest):
                yield self.finding(
                    ctx, node,
                    f"{name}(...) writes a checkpoint directly to its "
                    "final path: a writer killed mid-write leaves a TORN "
                    "file the next load explodes on; route through "
                    "utils/checkpoint.py (save_train_state / "
                    "save_state_dict / _atomic_write: mkstemp + fsync + "
                    "atomic replace)",
                )
        flagged: set[ast.AST] = set()
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for node in self._unguarded_loop_nodes(loop):
                if node in flagged:
                    continue
                name = self._helper_call(node)
                if name is None:
                    hit = self._writer_call(node)
                    name = hit[0] if hit else None
                if name is None:
                    continue
                flagged.add(node)
                yield self.finding(
                    ctx, node,
                    f"{name}(...) runs on EVERY iteration of this loop: "
                    "an unguarded in-loop checkpoint write serializes a "
                    "full state copy + disk write into each step; gate it "
                    "on a cadence (`if step % N == 0:` / "
                    "`if checkpointer.due(step):` — "
                    "resilience/checkpoint.py) or move it out of the loop",
                )


# ---------------------------------------------------------------------------
# JL015 — unbounded rendezvous / unsupervised training-script launches


# torch's world-formation entry point, matched on the dotted tail so
# ``torch.distributed.init_process_group`` and ``dist.init_process_group``
# both resolve.
_RDZV_TAILS = ("init_process_group",)
_LAUNCH_CALLS = {"subprocess.call", "subprocess.Popen", "Popen"}


class ElasticLaunchRule(Rule):
    """JL015: a world-formation or process-launch call with no failure
    story.

    (a) **Unbounded rendezvous**: a bare
    ``torch.distributed.init_process_group(...)`` with no ``timeout=`` and
    no surrounding bounded-retry shape (a ``for ... in range(...)`` loop)
    inherits the process group's default timeout of many minutes — one
    dead or late rank wedges the whole gang with zero diagnostics.  Route
    through ``parallel/distributed.initialize_with_retry`` (bounded
    attempts inside ``--rdzv-timeout-s``, a who-is-missing error) or at
    least pass the timeout.

    (b) **Unsupervised launch**: a ``subprocess.call``/``Popen`` of a
    Python script (``sys.executable`` or a ``*.py`` argument) in a module
    with NO signal handling anywhere.  A SIGTERM to such a launcher
    orphans the child and a dead child is never detected, restarted, or
    even reported.  Launcher-shaped modules forward signals and supervise
    (``parallel/elastic.GangSupervisor``); one-shot probe drivers that
    deliberately fire-and-collect are waived inline with a reason.
    """

    rule_id = "JL015"
    severity = Severity.WARNING
    summary = "unbounded rendezvous or unsupervised training-script launch"

    @staticmethod
    def _is_initialize(node: ast.Call) -> bool:
        name = dotted_name(node.func)
        return name is not None and any(
            name == tail or name.endswith("." + tail) for tail in _RDZV_TAILS
        )

    @staticmethod
    def _in_bounded_retry(node: ast.AST, parents: dict) -> bool:
        cur = parents.get(node)
        while cur is not None:
            if _is_bounded_for(cur):
                return True
            cur = parents.get(cur)
        return False

    @staticmethod
    def _is_script_cmd(cmd: ast.AST, script_names: set[str]) -> bool:
        if isinstance(cmd, ast.Name) and cmd.id in script_names:
            return True
        elements: list[ast.AST] = []
        if isinstance(cmd, (ast.List, ast.Tuple)):
            elements = list(cmd.elts)
            for el in cmd.elts:
                if isinstance(el, ast.Starred):
                    elements.append(el.value)
        else:
            elements = [cmd]
        for el in elements:
            if dotted_name(el) == "sys.executable":
                return True
            if (isinstance(el, ast.Constant) and isinstance(el.value, str)
                    and el.value.endswith(".py")):
                return True
        return False

    @classmethod
    def _script_cmd_names(cls, tree: ast.Module) -> set[str]:
        names: set[str] = set()
        for node in ast.walk(tree):
            if (isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, (ast.List, ast.Tuple))
                    and cls._is_script_cmd(node.value, set())):
                names.add(node.targets[0].id)
        return names

    @classmethod
    def _is_script_launch(cls, node: ast.Call, script_names: set[str]) -> bool:
        if dotted_name(node.func) not in _LAUNCH_CALLS or not node.args:
            return False
        return cls._is_script_cmd(node.args[0], script_names)

    @staticmethod
    def _module_handles_signals(tree: ast.Module) -> bool:
        for node in ast.walk(tree):
            if isinstance(node, ast.Name) and node.id in (
                "signal", "GangSupervisor",
            ):
                return True
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names]
                if "signal" in names or getattr(node, "module", None) == "signal":
                    return True
                if "GangSupervisor" in names:
                    return True
            if isinstance(node, ast.Attribute) and node.attr in (
                "send_signal", "install_signals",
            ):
                return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(ctx.tree):
            for child in ast.iter_child_nodes(parent):
                parents[child] = parent
        signal_aware = self._module_handles_signals(ctx.tree)
        script_names = self._script_cmd_names(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if self._is_initialize(node):
                has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
                if not has_timeout and not self._in_bounded_retry(node, parents):
                    yield self.finding(
                        ctx, node,
                        "torch.distributed.init_process_group(...) with no "
                        "timeout= and no bounded-retry shape: one dead or "
                        "late rank hangs the gang for the process group's "
                        "default timeout with zero diagnostics; route "
                        "through parallel/distributed.initialize_with_retry "
                        "(bounded attempts inside --rdzv-timeout-s, a "
                        "who-is-missing error) or pass the timeout",
                    )
            elif self._is_script_launch(node, script_names) and not signal_aware:
                yield self.finding(
                    ctx, node,
                    f"{dotted_name(node.func)}(...) launches a Python "
                    "script from a module with no signal handling: SIGTERM "
                    "to this launcher orphans the child (silently defeating "
                    "the trainer's emergency-save path) and a dead child is "
                    "never detected or restarted; forward signals and "
                    "supervise (parallel/elastic.GangSupervisor, "
                    "parallel/launch.py)",
                )


# ---------------------------------------------------------------------------
# JL016 — deadline-blind fixed linger in a dispatch loop


_DEADLINE_HINTS = ("deadline", "remaining", "budget", "expire", "due")
_SLEEP_CALLS = {"time.sleep", "sleep"}


class FixedLingerDispatchRule(Rule):
    """JL016: a dispatch loop that sleeps a FIXED linger, blind to
    request deadlines.

    The shape ``while True: batch = drain(queue); time.sleep(LINGER);
    engine.launch(batch)`` makes every request pay the linger, including
    the one whose deadline budget is nearly spent — which then expires in
    the batch or answers at p99 instead of p50.  The taught idiom
    (serving/batcher.py ``_close_at``) computes the batch close from
    ``min(global linger, oldest member's deadline - service estimate)``.

    Heuristics: fires on a ``time.sleep(X)`` where (a) the enclosing loop
    is unbounded; (b) the same loop body launches
    (:func:`is_launch_call`); (c) ``X`` is a numeric constant or a
    linger-named value; and (d) NOTHING in the loop body mentions a
    deadline-shaped name (deadline/remaining/budget/expire/due).  A
    deliberately fixed cadence (a metronome-style replay driver) is
    waived inline with a reason.
    """

    rule_id = "JL016"
    severity = Severity.WARNING
    summary = "dispatch loop sleeps a fixed linger, blind to request deadlines"

    @staticmethod
    def _fixed_sleep(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        if dotted_name(node.func) not in _SLEEP_CALLS or not node.args:
            return False
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, (int, float)):
            return True
        return "linger" in (dotted_name(arg) or "").lower()

    @staticmethod
    def _mentions_deadline(body_nodes: list[ast.AST]) -> bool:
        for node in body_nodes:
            label = ""
            if isinstance(node, ast.Attribute):
                label = (dotted_name(node) or node.attr).lower()
            elif isinstance(node, ast.Name):
                label = node.id.lower()
            if label and any(h in label for h in _DEADLINE_HINTS):
                return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        attrs = launch_attr_names(ctx.tree)
        for loop, names in loops_with_launch_names(ctx.tree):
            if _is_bounded_for(loop):
                continue  # a bounded replay/retry is not a dispatch loop
            body_nodes = list(iter_loop_body_nodes(loop))
            if not any(is_launch_call(n, names, attrs) for n in body_nodes):
                continue
            if self._mentions_deadline(body_nodes):
                continue
            for node in body_nodes:
                if self._fixed_sleep(node):
                    yield self.finding(
                        ctx, node,
                        "fixed linger sleep inside a dispatch loop that "
                        "never consults request deadlines: every request "
                        "pays the full linger, and one whose budget is "
                        "nearly spent expires in the batch or answers at "
                        "p99; close the batch from the oldest member's "
                        "remaining deadline budget instead "
                        "(serving/batcher.py _close_at — "
                        "min(linger, deadline - service estimate))",
                    )


# ---------------------------------------------------------------------------
# JL017 — blocking network read without a timeout in an unbounded loop


_TIMEOUT_PARAM_CALLS = (
    ({"urlopen", "urllib.request.urlopen", "request.urlopen"}, 2),
    ({"create_connection", "socket.create_connection"}, 1),
)
_RAW_READ_ATTRS = {"recv", "recv_into", "getresponse", "accept"}
_NET_DEADLINE_HINTS = (
    "deadline", "remaining", "budget", "timeout", "expire", "due",
)


class BlockingNetReadLoopRule(Rule):
    """JL017: a blocking socket/HTTP read without a timeout inside an
    unbounded control-plane or dispatch loop.

    A supervisor, poller, or proxy loop that calls ``urlopen(url)`` (no
    timeout), ``socket.create_connection(addr)`` (no timeout), or a raw
    ``sock.recv()`` / ``conn.getresponse()`` with no socket deadline
    anywhere in the loop hangs FOREVER the first time the peer wedges.
    The taught idiom is the fleet front's per-attempt deadline
    (serving/fleet.py ``Backend.request``).

    Heuristics: inside an unbounded loop, fires on (a) a
    timeout-parameterized call (``urlopen``, ``create_connection``) whose
    ``timeout`` is neither a keyword nor covered positionally; and (b) a
    raw read (``.recv``/``.recv_into``/``.getresponse``/``.accept``) when
    NOTHING in the loop body mentions a deadline-shaped name.  A
    deliberately blocking accept loop (a test fixture server) is waived
    inline with a reason.
    """

    rule_id = "JL017"
    severity = Severity.WARNING
    summary = "blocking network read without a timeout in an unbounded loop"

    @staticmethod
    def _missing_timeout_call(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        name = dotted_name(node.func)
        for spellings, timeout_pos in _TIMEOUT_PARAM_CALLS:
            if name in spellings:
                if any(kw.arg == "timeout" for kw in node.keywords):
                    return False
                if any(kw.arg is None for kw in node.keywords):
                    return False  # **kwargs may carry it; benefit of doubt
                return len(node.args) <= timeout_pos
        return False

    @staticmethod
    def _raw_read_call(node: ast.AST) -> bool:
        return (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _RAW_READ_ATTRS
        )

    @staticmethod
    def _mentions_net_deadline(body_nodes: list[ast.AST]) -> bool:
        for node in body_nodes:
            label = ""
            if isinstance(node, ast.Attribute):
                label = (dotted_name(node) or node.attr).lower()
            elif isinstance(node, ast.Name):
                label = node.id.lower()
            elif isinstance(node, ast.keyword) and node.arg:
                label = node.arg.lower()
            if label and any(h in label for h in _NET_DEADLINE_HINTS):
                return True
        return False

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            if _is_bounded_for(loop):
                continue  # a bounded replay/retry is not a control loop
            body_nodes = list(iter_loop_body_nodes(loop))
            deadline_aware = self._mentions_net_deadline(body_nodes)
            for node in body_nodes:
                if self._missing_timeout_call(node):
                    yield self.finding(
                        ctx, node,
                        "network call with its timeout parameter unset "
                        "inside an unbounded loop: the first wedged peer "
                        "hangs this loop forever — and a control-plane "
                        "loop is usually the thing that was supposed to "
                        "DETECT the wedge; pass timeout= (the fleet "
                        "tier's per-attempt deadline, serving/fleet.py "
                        "Backend.request)",
                    )
                elif not deadline_aware and self._raw_read_call(node):
                    yield self.finding(
                        ctx, node,
                        "raw blocking read (.recv/.getresponse/.accept) "
                        "in an unbounded loop that never touches a "
                        "timeout or deadline: set a socket timeout "
                        "(settimeout) or compute a per-attempt deadline "
                        "from the remaining budget (serving/fleet.py "
                        "Backend.request)",
                    )


# ---------------------------------------------------------------------------
# JL018 — float-list JSON serialization in an unbounded dispatch/serve loop


_JSON_DUMP_CALLS = {"json.dumps", "dumps", "json.dump"}


class FloatListJSONLoopRule(Rule):
    """JL018: ``json.dumps`` of ``.tolist()``'d array data inside an
    unbounded dispatch/serve loop.

    Rendering an array as a JSON float list costs ~1 µs per element on
    the way out and the same again at the peer's parse — for a 784-pixel
    MNIST row batch that is MILLISECONDS of pure text work per request,
    paid on every iteration of a loop that never ends.  The taught idiom
    is the binary wire path (serving/wire.py): a fixed header plus raw
    float32 bytes.  For one-shot reports (bounded work), float-list JSON
    is fine and this rule stays silent.

    Heuristics: fires on a ``json.dumps``/``json.dump`` call whose
    argument subtree contains a ``.tolist()`` call inside an unbounded
    loop.  A deliberately-JSON streamer (a debug endpoint, a
    compatibility shim) is waived inline with a reason.
    """

    rule_id = "JL018"
    severity = Severity.WARNING
    summary = (
        "float-list JSON serialization of array data in an unbounded "
        "dispatch/serve loop"
    )

    @staticmethod
    def _tolist_inside(node: ast.AST) -> bool:
        return any(
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "tolist"
            for sub in ast.walk(node)
        )

    def _dumps_of_tolist(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        if dotted_name(node.func) not in _JSON_DUMP_CALLS:
            return False
        return any(self._tolist_inside(arg) for arg in node.args) or any(
            kw.value is not None and self._tolist_inside(kw.value)
            for kw in node.keywords
        )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            if _is_bounded_for(loop):
                continue  # a bounded replay/report pass is not a serve loop
            for node in iter_loop_body_nodes(loop):
                if self._dumps_of_tolist(node):
                    yield self.finding(
                        ctx, node,
                        "array data rendered as a JSON float list inside "
                        "an unbounded loop: every iteration pays "
                        "per-element text encode (and the peer pays the "
                        "matching parse) — milliseconds per request of "
                        "pure host work; send raw bytes instead "
                        "(serving/wire.py: fixed header + tobytes(), "
                        "parsed with one zero-copy np.frombuffer)",
                    )


# ---------------------------------------------------------------------------
# JL022 — weights loaded or mutated behind the registry's back (serving)


# Checkpoint-load spellings whose return value is a live weight set: the
# JAX package's names, the port's loader (utils/checkpoint.py) and
# torch.load itself.
_WEIGHT_LOAD_CALLS = {
    "load_inference_variables", "load_inference_state", "load_state_dict",
    "load_variables",
}
_WEIGHT_LOAD_NAMES = {"torch.load"}
_WEIGHT_SURFACE_ATTRS = {"variables", "weights_digest"}
_REGISTRY_SURFACE_MODULES = {"registry.py", "rollout.py", "engine.py"}


class RegistryBypassRule(Rule):
    """JL022: a serving module loads checkpoint weights or mutates the
    engine weight surface directly instead of going through the model
    registry.

    Once ``ModelRegistry`` owns (model, version) → (checkpoint, digest),
    any serving-side code that loads a checkpoint itself — or reassigns
    ``engine.variables`` / ``engine.weights_digest`` from outside the
    engine — creates a weight state the registry cannot see: the served
    digest no longer matches the manifest and the response cache keeps
    answering from the OLD weights.  The taught idiom is the registry
    surface (serving/registry.py ``resolve()`` + ``load()``,
    ``publish()``) and ``RolloutController.swap()`` /
    ``engine.publish_weights()`` for a live cutover.

    Heuristics: applies only to modules under a ``serving/`` path
    component, excluding ``registry.py``, ``rollout.py`` and
    ``engine.py``.  Fires on (a) any call whose name's last segment is a
    checkpoint-load spelling (``load_inference_state`` /
    ``load_inference_variables`` / ``load_state_dict`` /
    ``load_variables``) or is ``torch.load``, and (b) any assignment to
    ``<non-self>.variables`` or ``<non-self>.weights_digest``.  A
    pre-registry CLI path is waived inline with a reason.
    """

    rule_id = "JL022"
    severity = Severity.WARNING
    summary = (
        "checkpoint weights loaded or engine weight surface mutated "
        "outside the model registry in a serving module"
    )

    @staticmethod
    def _in_scope(ctx: ModuleContext) -> bool:
        parts = ctx.path.replace("\\", "/").split("/")
        if "serving" not in parts[:-1]:
            return False
        return parts[-1] not in _REGISTRY_SURFACE_MODULES

    @staticmethod
    def _load_call(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        name = dotted_name(node.func)
        if not name:
            return False
        return name in _WEIGHT_LOAD_NAMES or _last(name) in _WEIGHT_LOAD_CALLS

    @staticmethod
    def _foreign_weight_target(node: ast.AST) -> bool:
        return (
            isinstance(node, ast.Attribute)
            and node.attr in _WEIGHT_SURFACE_ATTRS
            and not (isinstance(node.value, ast.Name)
                     and node.value.id == "self")
        )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not self._in_scope(ctx):
            return
        for node in ast.walk(ctx.tree):
            if self._load_call(node):
                yield self.finding(
                    ctx, node,
                    "checkpoint weights loaded directly in a serving "
                    "module: the registry cannot see this weight state "
                    "— the served digest diverges from the manifest and "
                    "the response cache keys stay pinned to the last "
                    "published digest; resolve through the registry "
                    "surface instead (serving/registry.py "
                    "ModelRegistry.resolve()/load(), publish() to admit "
                    "a new checkpoint)",
                )
                continue
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                targets = list(node.targets)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for target in targets:
                if self._foreign_weight_target(target):
                    yield self.finding(
                        ctx, node,
                        "engine weight surface mutated from outside the "
                        "engine: reassigning .variables/.weights_digest "
                        "behind the registry skips digest verification "
                        "and cache invalidation — a torn or invisible "
                        "swap; use engine.publish_weights() via "
                        "RolloutController.swap() (serving/rollout.py) "
                        "so the cutover is digest-checked, "
                        "cache-invalidating, and on the record",
                    )


# ---------------------------------------------------------------------------
# JL023 — per-item pow2 padding inside a dispatch loop (packed batching)


_POW2_PAD_HELPERS = {
    "pad_to_bucket", "next_power_of_two", "bucket_for", "pow2_buckets",
}
# Raw pad spellings that, fed a bucket-derived width, reimplement
# pad_to_bucket inline.
_RAW_PAD_CALLS = {
    "np.pad", "numpy.pad", "F.pad", "torch.nn.functional.pad",
    "nn.functional.pad",
}


class Pow2PadDispatchRule(Rule):
    """JL023: per-item pow2/bucket padding inside an unbounded dispatch
    loop outside the bucket helper module.

    Padding each request up to its pow2 bucket inside the dispatch loop
    burns device rows on padding and re-grows the per-bucket rung ladder
    the packed rows-capacity path collapsed.  Padding is a *formation*
    decision, made once, behind the serving surface: the bucketed path
    owns it in ``serving/buckets.py`` (``StagingPool`` +
    ``pad_to_bucket``), and the packed path replaces it with segment-id
    concatenation.

    Heuristics: inside unbounded loops, fires on (a) any call whose name's
    last segment is ``pad_to_bucket``, and (b) any ``np.pad`` /
    ``F.pad`` call with a bucket-math helper call
    (``next_power_of_two``/``bucket_for``/``pow2_buckets``) anywhere in
    its arguments.  ``serving/buckets.py`` itself is exempt.
    """

    rule_id = "JL023"
    severity = Severity.WARNING
    summary = (
        "per-item pow2/bucket padding inside a dispatch loop; let the "
        "batcher form batches (packed, or StagingPool-bucketed) instead"
    )

    @staticmethod
    def _in_scope(ctx: ModuleContext) -> bool:
        parts = ctx.path.replace("\\", "/").split("/")
        return not (parts[-1] == "buckets.py" and "serving" in parts[:-1])

    @staticmethod
    def _helper_call(node: ast.AST, names: set[str]) -> bool:
        return (isinstance(node, ast.Call)
                and _last(dotted_name(node.func)) in names)

    @classmethod
    def _pow2_pad(cls, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        if cls._helper_call(node, {"pad_to_bucket"}):
            return True
        if dotted_name(node.func) not in _RAW_PAD_CALLS:
            return False
        in_args = list(node.args) + [
            kw.value for kw in node.keywords if kw.value is not None
        ]
        return any(
            cls._helper_call(sub, _POW2_PAD_HELPERS)
            for arg in in_args
            for sub in ast.walk(arg)
        )

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        if not self._in_scope(ctx):
            return
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            if _is_bounded_for(loop):
                continue  # a bounded replay/report pass is not a serve loop
            for node in iter_loop_body_nodes(loop):
                if self._pow2_pad(node):
                    yield self.finding(
                        ctx, node,
                        "pow2/bucket padding inside an unbounded dispatch "
                        "loop: every iteration pays padding rows the "
                        "device computes and throws away, and each "
                        "distinct bucket shape grows the rung ladder — "
                        "the waste packed batching deletes "
                        "(serving/batcher.py packed mode: requests "
                        "concatenate into one rows-capacity buffer + "
                        "segment ids, padding only the single buffer "
                        "tail); form batches behind the serving surface "
                        "instead of padding per item here",
                    )


# ---------------------------------------------------------------------------
# JL024 — sharded predict-step built over an inline mesh inside a loop


# Mesh constructors: the JAX package's names, the port's replica mesh
# (serving/devices.py) and its lockstep controller (parallel/mesh.py).
_MESH_BUILDER_CALLS = {
    "Mesh", "make_mesh", "make_2d_mesh", "make_nd_mesh",
    "single_device_mesh", "replica_mesh", "ReplicaMesh", "Lockstep",
}


class ShardedStepMeshLoopRule(Rule):
    """JL024: sharded predict-step construction closing over a mesh
    built inside the same dispatch/warmup loop.

    The predict-step builders (``make_tp_predict_step``,
    ``make_ep_predict_step``, ``make_pp_predict_step``, ...,
    ``sharded.build_predict_fn``) close over a concrete replica mesh and
    its ``Lockstep`` controller.  In the port a mesh built afresh each
    loop iteration retraces nothing — there is no trace — but it costs
    more: every shard's weights are placed on their devices again, and
    the new ``Lockstep`` makes new CUDA streams, one a shard, so each
    pass pays a full host-to-device copy of the replica and its streams'
    creation before its first forward.  The sanctioned pattern threads
    ONE mesh in from outside the loop (serving/pool.py plans replica
    meshes once, at construction) or uses a module-level mesh.

    Heuristics: fires on any call whose name's last segment looks like
    ``make_*predict_step`` or is ``build_predict_fn`` inside any loop
    body when its mesh argument (first positional, or ``mesh=`` /
    ``lock=``) is (a) an inline mesh-builder call, or (b) a name assigned
    from one of those inside the same loop body.  A mesh threaded in as a
    parameter or built at module level is exempt — that is the fix.
    Bounded loops are NOT exempt here: a per-iteration mesh costs the
    same in a bounded warmup sweep as in a serve loop.
    """

    rule_id = "JL024"
    severity = Severity.WARNING
    summary = (
        "sharded predict-step built over a mesh created inside the "
        "loop; build the mesh once outside and thread it in"
    )

    @staticmethod
    def _mesh_builder_call(node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and _last(dotted_name(node.func)) in _MESH_BUILDER_CALLS)

    @staticmethod
    def _step_builder_call(node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        last = _last(dotted_name(node.func))
        return last == "build_predict_fn" or (
            last.startswith("make_") and last.endswith("predict_step")
        )

    @staticmethod
    def _mesh_args(call: ast.Call) -> list[ast.AST]:
        kws = [kw.value for kw in call.keywords if kw.arg in ("mesh", "lock")]
        return kws or list(call.args[:1])

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            body = list(iter_loop_body_nodes(loop))
            loop_meshes: set[str] = set()
            for node in body:
                if isinstance(node, ast.Assign):
                    targets, value = list(node.targets), node.value
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    targets, value = [node.target], node.value
                else:
                    continue
                if self._mesh_builder_call(value):
                    loop_meshes.update(
                        t.id for t in targets if isinstance(t, ast.Name)
                    )
            for node in body:
                if not self._step_builder_call(node):
                    continue
                if any(
                    self._mesh_builder_call(mesh)
                    or (isinstance(mesh, ast.Name) and mesh.id in loop_meshes)
                    for mesh in self._mesh_args(node)
                ):
                    yield self.finding(
                        ctx, node,
                        "predict-step builder closing over a mesh created "
                        "inside the loop: every iteration places each "
                        "shard's weights on its device again and makes new "
                        "streams for the Lockstep — build the replica mesh "
                        "ONCE outside the loop (serving/pool.py plans "
                        "meshes at construction) and thread it in",
                    )


ALL_RULES: tuple[Rule, ...] = (
    BlockingReadLoopRule(),
    HostBlockingFeedRule(),
    EngineLoopRule(),
    SwallowedDispatchErrorRule(),
    CheckpointWriteRule(),
    ElasticLaunchRule(),
    FixedLingerDispatchRule(),
    BlockingNetReadLoopRule(),
    FloatListJSONLoopRule(),
    RegistryBypassRule(),
    Pow2PadDispatchRule(),
    ShardedStepMeshLoopRule(),
)


def rule_by_id(rule_id: str) -> Rule:
    for rule in ALL_RULES:
        if rule.rule_id == rule_id.upper():
            return rule
    raise KeyError(f"unknown rule id {rule_id!r}")
