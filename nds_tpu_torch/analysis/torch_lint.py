# Copyright (c) 2026, nds-tpu authors. Licensed under the Apache License, Version 2.0.
"""Host-read hazard lint of the port: static checks over ``nds_tpu_torch/``.

Python-``ast`` based; imports no torch and runs nothing. It is the torch
reading of the reference's ``analysis/jax_lint.py``: where the reference
polices jitted regions, ``shard_map`` bodies and Pallas kernels, this lint
polices CUDA-graph capture bodies, the bodies that run per shard under
``ops.device_scope`` and the launch path of the hand-written kernels.
Every rule is suppressible with ``# nds-lint: ignore[rule]`` on the
flagged line or on a comment-only line above it.

**Host-sync primitives** (one shared matcher): ``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()``, ``.to_int()``; ``bool()``, ``int()`` or
``float()`` of a call that returns a tensor (a ``torch.*`` call or a
reduction method such as ``.sum()``, ``.max()``, ``.any()``);
``np.asarray`` and ``np.array``; ``torch.cuda.synchronize``; and the
engine's counted reads: ``host_read``, ``timed_read``,
``guarded_scalar_read``, ``to_host`` (``engine/ops.py``) and
``host_sync``, ``count_int``, ``resolve_counts``. A primitive inside the
arguments of a counted read is the read itself and is not flagged again.

**Capture bodies** are the functions called lexically between a
``capture_begin`` and a ``capture_end`` call, or inside ``with
torch.cuda.graph(...)``: today ``StreamPipeline._program``
(``engine/stream.py``) and ``CompiledQuery._replay_planner``
(``engine/replay.py``). A capture records kernels once and replays them:
a host read inside raises (the captures run under
``torch.cuda.set_sync_debug_mode("error")``, which only the card sees),
and host values are read once, at capture. **Shard bodies** are the
blocks under ``with ops.device_scope(...)`` and the module-local
functions called in them. **Kernel wrappers** are the functions of a
module that count a launch (``LAUNCHES[k] += 1``), the module-local
functions they call (their argument builders, not the ``*_plain``
versions) and the module-local functions that call them. Bodies resolve
by name within the module, and a call from a body to a module-local
helper whose own body syncs directly is flagged at the call site (one
level down; ``self.helper()`` resolves only within its class).

Rules, each the torch reading of a reference rule:

* ``host-sync-in-loop`` (warning; reference: same name) — a host-sync
  primitive inside a ``for``/``while`` of the hot-path modules
  (``engine/ops.py``, ``sql/planner.py``). The accounted reads are
  baselined.
* ``tensor-if-in-capture`` (error; reference: ``tracer-if``) — a Python
  ``if``/``while`` whose test references a parameter of a capture body
  (identity tests and ``.dtype``/``.shape``/``.ndim``/``.device``
  metadata excepted; ``self`` is no operand), and a host-sync primitive in
  a capture body, directly or one level down: ``bool(tensor)`` is a host
  read, the capture's tracer error.
* ``cache-key-list`` (error; same) — a ``list``/``set``/``dict`` display
  or comprehension in a ``*_CACHE`` key, also through a parameter a
  ``*_CACHE`` is passed as.
* ``unbounded-cache`` (warning; same) — a module ``*_CACHE`` written with
  no eviction evidence (a ``len()`` guard, ``pop``/``popitem``/``clear``).
* ``time-in-capture`` (error; ``time-in-jit``) — ``time.*`` in a capture
  body: read once at capture, never at replay.
* ``span-in-capture`` (error; ``span-in-jit``) — an obs span in a capture
  body: it clocks the capture, not the replays.
* ``host-sync-in-shard-body`` (error; ``host-sync-in-shard-map``) — a
  host-sync primitive or an obs span in a shard body.
* ``host-read-in-kernel-wrapper`` (error; ``host-read-in-pallas``) — a
  host-sync primitive or an obs span on a kernel wrapper's launch path
  (``engine/kernels.py``: the K1-K5 wrappers and ``_seg_args``,
  ``_scan_args``, ``_probe_args``). The execution auditor prices K4 and
  K5 at zero syncs.
* ``host-sync-in-prefetch-worker`` (error; same) — a host-sync primitive
  or an obs span in a callable the prefetch ring (``chunk_ring``,
  ``ChunkRing``) runs on its worker thread, whose sync counters and span
  ring are its own.
* ``swallowed-fault`` (error; same) — an ``except`` of ``FaultError``,
  ``FaultInjected`` or ``StatementTimeout`` that neither records a
  ``FaultEvent`` (``record_fault_event``) nor re-raises.
* ``chunk-loop-host-sync`` (warning; same) — a host-sync primitive inside
  a ``for`` loop over ``device_chunks()``, ``padded_chunks()`` or
  ``host_chunks()`` in any module, one level down too: one sync a chunk
  is the cost the compiled streamed pipeline removes.

Two port hazards that ``set_sync_debug_mode`` cannot see:

* ``host-scalar-div`` (warning; hazard H6) — a true division by a numeric
  literal, a ``10 ** k`` expression or a ``float(...)`` call in
  ``engine/`` or ``sql/``: on CUDA torch divides a tensor by a host
  scalar as a multiplication by its reciprocal, one ulp off the IEEE
  quotient. The repair is ``prim.true_div``; a host-side division is
  baselined with its reason.
* ``cache-write-in-capture`` (error) — a write to a ``*_CACHE`` in a
  capture body or a chunk loop that no ``ops.staging()`` check guards: a
  tensor allocated while a graph is captured belongs to the graph's pool.
  A ``staging()`` call earlier in the enclosing function is the guard.
"""

from __future__ import annotations

import ast
import os

from nds_tpu_torch.analysis import Finding, suppressed

# modules whose loops are hot paths (per-statement, per-chunk dispatch)
HOT_PATH_FILES = ("engine/ops.py", "sql/planner.py")
# package directories whose divisions the host-scalar-div rule reads
DIV_DIRS = ("engine/", "sql/")

_SYNC_NP_FUNCS = {"asarray", "array"}
_TIME_FUNCS = {"time", "perf_counter", "perf_counter_ns", "monotonic",
               "monotonic_ns", "time_ns", "process_time"}
# iterators that yield the chunks of a streamed table
_CHUNK_ITER_FUNCS = {"device_chunks", "padded_chunks", "host_chunks"}
# engine entry points that resolve a device scalar on the host
_ENGINE_SYNC_FUNCS = {"host_sync", "count_int", "resolve_counts"}
# ops.host_read-charging entry points (every counted device-to-host read
# funnels through host_read) and the uncounted copy inside a counted fetch
_HOST_READ_FUNCS = {"host_read", "timed_read", "guarded_scalar_read",
                    "to_host"}
# tensor methods without arguments that read the device
_TENSOR_READ_METHODS = {"item", "cpu", "tolist", "numpy", "to_int"}
# tensor-returning methods: int()/float()/bool() of one is a host read
_TENSOR_REDUCTIONS = {"sum", "max", "min", "any", "all", "count_nonzero",
                      "amax", "amin", "prod", "mean", "argmax", "argmin",
                      "nonzero"}
_HOST_OWNERS = {"np", "numpy", "math", "builtins", "pa", "pc", "os"}
# the fault layer's classified errors (engine/faults.py)
_FAULT_ERROR_NAMES = {"FaultError", "FaultInjected", "StatementTimeout"}
_FAULT_RECORD_FUNCS = {"record_fault_event"}
# attributes that are metadata on a tensor (no host read)
_METADATA_ATTRS = {"dtype", "shape", "ndim", "device", "is_cuda",
                   "layout"}


def _call_name(f) -> str | None:
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _tensor_call(node) -> bool:
    """Whether a Call visibly returns a tensor: a ``torch.*`` call or a
    reduction method on a non-host owner."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if not isinstance(f, ast.Attribute):
        return False
    root = f.value
    while isinstance(root, ast.Attribute):
        root = root.value
    if isinstance(root, ast.Name) and root.id == "torch":
        return True
    owner = f.value.id if isinstance(f.value, ast.Name) else None
    return f.attr in _TENSOR_REDUCTIONS and owner not in _HOST_OWNERS


def _is_counted_read(node) -> bool:
    return isinstance(node, ast.Call) and \
        _call_name(node.func) in _HOST_READ_FUNCS


def _sync_primitive(node) -> str | None:
    """The host-sync primitive a Call node invokes, or None: the one
    matcher every rule and the one-level-down index share."""
    f = node.func
    if isinstance(f, ast.Attribute):
        owner = f.value.id if isinstance(f.value, ast.Name) else None
        if f.attr in _TENSOR_READ_METHODS and not node.args:
            return f".{f.attr}()"
        if owner in ("np", "numpy") and f.attr in _SYNC_NP_FUNCS:
            return f"np.{f.attr}()"
        if f.attr == "synchronize" and isinstance(f.value, ast.Attribute) \
                and f.value.attr == "cuda":
            return "torch.cuda.synchronize()"
        if f.attr in _ENGINE_SYNC_FUNCS or f.attr in _HOST_READ_FUNCS:
            return f"{f.attr}()"
    elif isinstance(f, ast.Name):
        if f.id in _ENGINE_SYNC_FUNCS or f.id in _HOST_READ_FUNCS:
            return f"{f.id}()"
        if f.id in ("int", "float", "bool") and len(node.args) == 1 \
                and _tensor_call(node.args[0]):
            return f"{f.id}(tensor)"
    return None


def _collect_sync_helpers(tree) -> dict:
    """Map each module-local function to ``(lineno, primitive)`` of the
    first host-sync primitive its body calls directly: the one-level-down
    index. Methods are keyed ``(ClassName, name)``, module-level or nested
    functions ``(None, name)``, so ``self.helper()`` resolves only against
    its own class; a nested def attributes to the innermost def."""
    helpers: dict = {}

    class _Scan(ast.NodeVisitor):
        def __init__(self):
            self.stack: list = []
            self.classes: list = []

        def visit_ClassDef(self, node):
            self.classes.append(node.name)
            self.generic_visit(node)
            self.classes.pop()

        def visit_FunctionDef(self, node):
            cls = self.classes[-1] if self.classes and not self.stack \
                else None
            self.stack.append((cls, node.name))
            self.generic_visit(node)
            self.stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            what = _sync_primitive(node)
            if what and self.stack:
                helpers.setdefault(self.stack[-1], (node.lineno, what))
            self.generic_visit(node)

    _Scan().visit(tree)
    return helpers


def _local_defs(tree) -> set:
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _callees(nodes) -> set:
    """Names of the functions called in ``nodes`` as a bare name or as
    ``self.method``."""
    out = set()
    for root in nodes:
        for n in ast.walk(root):
            if not isinstance(n, ast.Call):
                continue
            f = n.func
            if isinstance(f, ast.Name):
                out.add(f.id)
            elif isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and f.value.id == "self":
                out.add(f.attr)
    return out


def _is_graph_ctx(item) -> bool:
    """``with torch.cuda.graph(...)`` (or ``cuda.graph``)."""
    c = item.context_expr
    return isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute) \
        and c.func.attr == "graph" and isinstance(c.func.value,
                                                   ast.Attribute) \
        and c.func.value.attr == "cuda"


def _is_device_scope(item) -> bool:
    c = item.context_expr
    return isinstance(c, ast.Call) and _call_name(c.func) == "device_scope"


def _collect_capture_bodies(tree) -> set:
    """Names of the module-local functions a capture runs: called between
    a ``capture_begin`` and a ``capture_end`` call of one function (by
    line), or inside ``with torch.cuda.graph(...)``."""
    defs = _local_defs(tree)
    called: set = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        begins = [n.lineno for n in calls
                  if _call_name(n.func) == "capture_begin"]
        ends = [n.lineno for n in calls
                if _call_name(n.func) == "capture_end"]
        if begins and ends:
            lo, hi = min(begins), max(ends)
            inner = [n for n in calls if lo < n.lineno < hi]
            called |= _callees(inner)
        for w in ast.walk(fn):
            if isinstance(w, (ast.With, ast.AsyncWith)) and \
                    any(_is_graph_ctx(i) for i in w.items):
                called |= _callees(w.body)
    return called & defs


def _collect_shard_bodies(tree) -> set:
    """Names of the module-local functions called inside a ``with
    ...device_scope(...)`` block."""
    called: set = set()
    for w in ast.walk(tree):
        if isinstance(w, (ast.With, ast.AsyncWith)) and \
                any(_is_device_scope(i) for i in w.items):
            called |= _callees(w.body)
    return called & _local_defs(tree)


def _counts_launch(fn) -> bool:
    """A ``LAUNCHES[k] += n`` in the function's own body."""
    for n in ast.walk(fn):
        if isinstance(n, ast.AugAssign) and \
                isinstance(n.target, ast.Subscript) and \
                isinstance(n.target.value, ast.Name) and \
                n.target.value.id == "LAUNCHES":
            return True
    return False


def _collect_kernel_wrappers(tree) -> set:
    """The launch path: functions that count a launch, the module-local
    functions they call (``*_plain`` versions excepted) and the
    module-local functions that call them."""
    fns = {n.name: n for n in ast.walk(tree)
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    launch = {name for name, fn in fns.items() if _counts_launch(fn)}
    if not launch:
        return set()
    out = set(launch)
    for name in launch:
        out |= {c for c in _callees(fns[name].body)
                if c in fns and not c.endswith("_plain")}
    for name, fn in fns.items():
        if _callees(fn.body) & launch:
            out.add(name)
    return out


def _collect_prefetch_bodies(tree) -> set:
    """Names of callables the prefetch ring runs on its worker thread:
    arguments of a ``chunk_ring``/``ChunkRing`` call (positional or
    keyword, bare name or attribute) and the callee of a call passed as
    the source iterator (the generator's body runs on the worker too)."""
    bodies = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or \
                _call_name(node.func) not in ("chunk_ring", "ChunkRing"):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Call):
                arg = arg.func
            got = _call_name(arg)
            if got:
                bodies.add(got)
    return bodies


def _first_staging_lines(tree) -> dict:
    """``id(function node) -> first line`` of a ``staging()`` call in it."""
    out = {}
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            lines = [n.lineno for n in ast.walk(fn)
                     if isinstance(n, ast.Call)
                     and _call_name(n.func) == "staging"]
            if lines:
                out[id(fn)] = min(lines)
    return out


class _Lint(ast.NodeVisitor):
    def __init__(self, rel: str, source: str, tree):
        self.rel = rel
        self.sync_helpers = _collect_sync_helpers(tree)
        self.capture_bodies = _collect_capture_bodies(tree)
        self.shard_bodies = _collect_shard_bodies(tree)
        self.kernel_bodies = _collect_kernel_wrappers(tree)
        self.prefetch_bodies = _collect_prefetch_bodies(tree)
        self.staging_lines = _first_staging_lines(tree)
        self.lines = source.splitlines()
        self.findings: list = []
        self.scope_stack = ["<module>"]
        self.fn_stack: list = []       # enclosing function nodes
        self.class_stack: list = []
        self.loop_depth = 0
        self.chunk_loop_depth = 0
        self.capture_depth = 0
        self.capture_params: list = []  # operand-name sets of capture bodies
        self.shard_depth = 0
        self.kernel_depth = 0
        self.prefetch_depth = 0
        self.read_depth = 0            # inside a counted read's arguments
        self.is_hot = any(rel.endswith(h) for h in HOT_PATH_FILES)
        self.is_div = any(f"/{d}" in f"/{rel}" for d in DIV_DIRS)
        self.module_caches: set = set()
        self.cache_writes: dict = {}
        self.cache_evictions: set = set()
        self.fn_param_use: dict = {}
        self.param_use_stack: list = []
        self.cache_arg_calls: list = []
        # spans: names of the obs trace module (by convention or import
        # alias) and of its span() (by from-import); an unrelated .span()
        # (re.Match.span) or a local helper is no span
        self.obs_aliases: set = {"obs", "_obs", "obs_trace"}
        self.span_funcs: set = set()

    # -- imports --------------------------------------------------------------

    def visit_Import(self, node):
        for a in node.names:
            if a.asname and a.name.startswith("nds_tpu_torch.obs"):
                self.obs_aliases.add(a.asname)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if mod.startswith("nds_tpu_torch.obs") or mod == "nds_tpu_torch":
            for a in node.names:
                bound = a.asname or a.name
                if a.name == "span":
                    self.span_funcs.add(bound)
                elif a.name in ("trace", "export", "obs"):
                    self.obs_aliases.add(bound)
        self.generic_visit(node)

    def _emit(self, rule: str, severity: str, message: str,
              lineno: int) -> None:
        if suppressed(self.lines, lineno, rule):
            return
        self.findings.append(Finding(self.rel, self.scope_stack[-1], rule,
                                     severity, message, lineno))

    # -- scopes -----------------------------------------------------------------

    def visit_FunctionDef(self, node):
        self.scope_stack.append(node.name)
        self.fn_stack.append(node)
        args = node.args
        names = [a.arg for a in
                 args.posonlyargs + args.args + args.kwonlyargs]
        is_capture = node.name in self.capture_bodies
        if is_capture:
            operands = set(names) - {"self", "cls"}
        elif self.capture_depth:
            # a helper nested in a capture body runs under the capture:
            # closures over the body's operands stay operands (its own
            # parameters shadow them)
            operands = (self.capture_params[-1] if self.capture_params
                        else set()) - set(names)
        else:
            operands = set()
        self.capture_params.append(operands)
        self.capture_depth += is_capture
        self.param_use_stack.append((names, {}))
        flags = (node.name in self.shard_bodies,
                 node.name in self.kernel_bodies,
                 node.name in self.prefetch_bodies)
        self.shard_depth += flags[0]
        self.kernel_depth += flags[1]
        self.prefetch_depth += flags[2]
        saved = (self.loop_depth, self.chunk_loop_depth, self.read_depth)
        self.loop_depth = self.chunk_loop_depth = self.read_depth = 0
        self.generic_visit(node)
        self.loop_depth, self.chunk_loop_depth, self.read_depth = saved
        self.shard_depth -= flags[0]
        self.kernel_depth -= flags[1]
        self.prefetch_depth -= flags[2]
        self.capture_depth -= is_capture
        self.capture_params.pop()
        self.fn_param_use[node.name] = self.param_use_stack.pop()
        self.fn_stack.pop()
        self.scope_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.class_stack.append(node.name)
        self.generic_visit(node)
        self.class_stack.pop()

    def visit_With(self, node):
        scoped = any(_is_device_scope(i) for i in node.items)
        self.shard_depth += scoped
        self.generic_visit(node)
        self.shard_depth -= scoped

    visit_AsyncWith = visit_With

    # -- loops ------------------------------------------------------------------

    def visit_For(self, node):
        is_chunk = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in _CHUNK_ITER_FUNCS
            for n in ast.walk(node.iter))
        self.visit(node.iter)
        self.loop_depth += 1
        self.chunk_loop_depth += is_chunk
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        self.chunk_loop_depth -= is_chunk
        self.loop_depth -= 1

    visit_AsyncFor = visit_For

    def visit_While(self, node):
        self._check_capture_test(node.test, node.lineno, "while")
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_If(self, node):
        self._check_capture_test(node.test, node.lineno, "if")
        self.generic_visit(node)

    def _check_capture_test(self, test, lineno: int, kind: str) -> None:
        if not self.capture_depth:
            return
        operands = self.capture_params[-1]

        def hazardous(node) -> bool:
            # identity tests and tensor metadata read nothing
            if isinstance(node, ast.Compare) and \
                    all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in node.ops):
                return False
            if isinstance(node, ast.Attribute) and \
                    node.attr in _METADATA_ATTRS:
                return False
            if isinstance(node, ast.Call) and \
                    _call_name(node.func) in ("isinstance", "len"):
                return False
            if isinstance(node, ast.Name):
                return node.id in operands
            return any(hazardous(c) for c in ast.iter_child_nodes(node))

        if hazardous(test):
            names = sorted({n.id for n in ast.walk(test)
                            if isinstance(n, ast.Name)
                            and n.id in operands})
            self._emit("tensor-if-in-capture", "error",
                       f"Python {kind} on parameter "
                       f"{', '.join(repr(n) for n in names)} of a capture "
                       "body: on a tensor it is a host read, which a "
                       "capture refuses, and a host value is read once "
                       "at capture", lineno)

    # -- fault-layer recovery paths ---------------------------------------------

    def visit_Try(self, node):
        for h in node.handlers:
            if h.type is not None and self._catches_fault_error(h.type) \
                    and not self._handler_records_or_raises(h):
                self._emit(
                    "swallowed-fault", "error",
                    "except clause catches a classified fault "
                    "(FaultError family) but neither records a "
                    "FaultEvent (record_fault_event) nor re-raises: a "
                    "recovery must stay auditable", h.lineno)
        self.generic_visit(node)

    visit_TryStar = visit_Try

    @staticmethod
    def _catches_fault_error(type_expr) -> bool:
        for n in ast.walk(type_expr):
            if isinstance(n, ast.Name) and n.id in _FAULT_ERROR_NAMES:
                return True
            if isinstance(n, ast.Attribute) and \
                    n.attr in _FAULT_ERROR_NAMES:
                return True
        return False

    @staticmethod
    def _handler_records_or_raises(handler) -> bool:
        for stmt in handler.body:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Raise):
                    return True
                if isinstance(n, ast.Call) and \
                        _call_name(n.func) in _FAULT_RECORD_FUNCS:
                    return True
        return False

    # -- calls ------------------------------------------------------------------

    def _is_span(self, f) -> bool:
        return (isinstance(f, ast.Attribute) and f.attr == "span"
                and isinstance(f.value, ast.Name)
                and f.value.id in self.obs_aliases) or \
            (isinstance(f, ast.Name) and f.id in self.span_funcs)

    def _helper_hit(self, f):
        """``(name, primitive)`` when ``f`` calls a module-local helper
        whose body syncs directly, else None."""
        key = None
        if isinstance(f, ast.Name):
            key = (None, f.id)
        elif isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and f.value.id == "self" \
                and self.class_stack:
            key = (self.class_stack[-1], f.attr)
        hit = key is not None and self.sync_helpers.get(key)
        if not hit or key[1] in _CHUNK_ITER_FUNCS:
            return None
        return key[1], hit[1]

    def _check_region(self, node, what, rule: str, region: str,
                      why: str, bodies: set) -> None:
        """A host-sync primitive (``what``), a span, or a syncing helper
        one level down, inside a body of ``region``. A helper that is a
        body of the region itself is checked where it is defined, and a
        kernel's ``*_plain`` version (the CPU branch) is no launch
        path."""
        f = node.func
        if what or self._is_span(f):
            self._emit(rule, "error",
                       f"{what or 'obs.span(...)'} inside {region}: {why}",
                       node.lineno)
            return
        hit = self._helper_hit(f)
        if hit and hit[0] not in bodies and not hit[0].endswith("_plain"):
            name, prim = hit
            self._emit(rule, "error",
                       f"{name}() (defined in this module, syncs via "
                       f"{prim}) called inside {region}: "
                       "a host sync hidden one level down", node.lineno)

    def visit_Call(self, node):
        f = node.func
        what = None if self.read_depth else _sync_primitive(node)
        if self.chunk_loop_depth:
            if what:
                self._emit("chunk-loop-host-sync", "warning",
                           f"{what} inside a chunk loop syncs once a "
                           "chunk; keep the loop on the device or route "
                           "it through the compiled streamed pipeline",
                           node.lineno)
            else:
                hit = self._helper_hit(f)
                if hit:
                    name, prim = hit
                    self._emit("chunk-loop-host-sync", "warning",
                               f"{name}() (defined in this module, syncs "
                               f"via {prim}) called "
                               "inside a chunk loop: one host sync a "
                               "chunk hidden one level down", node.lineno)
        if self.capture_depth:
            if what:
                self._emit("tensor-if-in-capture", "error",
                           f"{what} inside a capture body: a host read "
                           "raises under capture and runs once, not at "
                           "replay", node.lineno)
            else:
                hit = self._helper_hit(f)
                if hit:
                    name, prim = hit
                    self._emit("tensor-if-in-capture", "error",
                               f"{name}() (defined in this module, syncs "
                               f"via {prim}) called "
                               "inside a capture body: a host read hidden "
                               "one level down", node.lineno)
            owner = f.value.id if isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) else None
            if owner in ("time", "_time") and f.attr in _TIME_FUNCS:
                self._emit("time-in-capture", "error",
                           f"time.{f.attr}() inside a capture body is "
                           "read once at capture, never at replay",
                           node.lineno)
            if self._is_span(f):
                self._emit("span-in-capture", "error",
                           "obs span inside a capture body clocks the "
                           "capture, not the replays; open it around the "
                           "replay instead", node.lineno)
        if self.shard_depth:
            self._check_region(
                node, what, "host-sync-in-shard-body",
                "a body that runs per shard under ops.device_scope",
                "each shard's host read is a round trip (and across "
                "processes a barrier); resolve once, before the shards, "
                "or ride the collective channels", self.shard_bodies)
        if self.kernel_depth:
            self._check_region(
                node, what, "host-read-in-kernel-wrapper",
                "a kernel wrapper's launch path",
                "the wrappers launch K1-K5 asynchronously and are priced "
                "at zero host syncs; take sizes from the host arguments",
                self.kernel_bodies)
        if self.prefetch_depth:
            self._check_region(
                node, what, "host-sync-in-prefetch-worker",
                "a prefetch-ring worker callable",
                "the worker's sync counters and span ring are its own, so "
                "a host read escapes the statement's accounting and a "
                "span lands unattributed", self.prefetch_bodies)
        if self.is_hot and self.loop_depth and what:
            self._emit("host-sync-in-loop", "warning",
                       f"{what} inside a hot-path loop blocks on a "
                       "device-to-host transfer each iteration",
                       node.lineno)
        self._note_cache_method_write(node)
        callee, self_off = None, 0
        if isinstance(f, ast.Name):
            callee = f.id
        elif isinstance(f, ast.Attribute) and \
                isinstance(f.value, ast.Name) and f.value.id == "self":
            callee, self_off = f.attr, 1
        if callee is not None:
            for i, a in enumerate(node.args):
                cname = self._is_cache_name(a)
                if cname:
                    self.cache_arg_calls.append(
                        (callee, i + self_off, cname))
            for kw in node.keywords:
                cname = self._is_cache_name(kw.value)
                if cname and kw.arg is not None:
                    self.cache_arg_calls.append((callee, kw.arg, cname))
        counted = _is_counted_read(node)
        self.read_depth += counted
        self.generic_visit(node)
        self.read_depth -= counted

    # -- host-scalar division (H6) ------------------------------------------

    def visit_BinOp(self, node):
        if self.is_div and isinstance(node.op, ast.Div) and \
                not isinstance(node.left, ast.Constant):
            r = node.right
            what = None
            if isinstance(r, ast.Constant) and \
                    isinstance(r.value, (int, float)) and \
                    not isinstance(r.value, bool):
                what = f"the literal {r.value!r}"
            elif isinstance(r, ast.BinOp) and isinstance(r.op, ast.Pow) \
                    and isinstance(r.left, ast.Constant) and \
                    r.left.value in (10, 10.0):
                what = "a 10 ** k expression"
            elif isinstance(r, ast.Call) and isinstance(r.func, ast.Name) \
                    and r.func.id == "float":
                what = "a float(...) call"
            if what:
                self._emit("host-scalar-div", "warning",
                           f"division by {what}: on CUDA a tensor divided "
                           "by a host scalar is multiplied by its "
                           "reciprocal, one ulp off the quotient; divide "
                           "through prim.true_div (H6)", node.lineno)
        self.generic_visit(node)

    # -- cache hygiene ----------------------------------------------------------

    def _is_cache_name(self, node) -> str | None:
        if isinstance(node, ast.Name) and node.id.endswith("_CACHE"):
            return node.id
        return None

    def _param_record(self, node) -> dict | None:
        if not (isinstance(node, ast.Name) and self.param_use_stack):
            return None
        params, records = self.param_use_stack[-1]
        if node.id not in params:
            return None
        return records.setdefault(node.id, {
            "write": None, "evict": False, "keyhaz": [],
            "scope": self.scope_stack[-1]})

    def _check_cache_write_guard(self, name: str, lineno: int) -> None:
        """cache-write-in-capture: a ``*_CACHE`` write in a capture body
        or a chunk loop with no ``staging()`` call before it in an
        enclosing function."""
        if not (self.capture_depth or self.chunk_loop_depth):
            return
        if any(self.staging_lines.get(id(fn), lineno + 1) <= lineno
               for fn in self.fn_stack):
            return
        where = "a capture body" if self.capture_depth else "a chunk loop"
        self._emit("cache-write-in-capture", "error",
                   f"{name} written inside {where} with no ops.staging() "
                   "guard: a tensor allocated while a graph is captured "
                   "comes from the graph's pool and must not be kept",
                   lineno)

    def visit_Assign(self, node):
        if self.scope_stack == ["<module>"]:
            for tgt in node.targets:
                name = self._is_cache_name(tgt)
                if name and isinstance(node.value, (ast.Dict, ast.Call)):
                    self.module_caches.add(name)
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                name = self._is_cache_name(tgt.value)
                if name:
                    self.cache_writes.setdefault(name, []).append(
                        tgt.lineno)
                    self._check_cache_key(name, tgt.slice, tgt.lineno)
                    self._check_cache_write_guard(name, tgt.lineno)
                else:
                    rec = self._param_record(tgt.value)
                    if rec is not None:
                        if rec["write"] is None:
                            rec["write"] = tgt.lineno
                        rec["keyhaz"].extend(
                            self._key_hazards(tgt.slice, tgt.lineno))
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if self.scope_stack == ["<module>"]:
            name = self._is_cache_name(node.target)
            if name and node.value is not None:
                self.module_caches.add(name)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if isinstance(node.ctx, ast.Load):
            name = self._is_cache_name(node.value)
            if name:
                self._check_cache_key(name, node.slice, node.lineno)
            else:
                rec = self._param_record(node.value)
                if rec is not None:
                    rec["keyhaz"].extend(
                        self._key_hazards(node.slice, node.lineno))
        self.generic_visit(node)

    def visit_Compare(self, node):
        # len(NAME_CACHE) >= ... is eviction evidence
        for sub in [node.left] + list(node.comparators):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Name) and \
                    sub.func.id == "len" and sub.args:
                name = self._is_cache_name(sub.args[0])
                if name:
                    self.cache_evictions.add(name)
                else:
                    rec = self._param_record(sub.args[0])
                    if rec is not None:
                        rec["evict"] = True
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if node.attr in ("pop", "popitem", "clear"):
            name = self._is_cache_name(node.value)
            if name:
                self.cache_evictions.add(name)
            else:
                rec = self._param_record(node.value)
                if rec is not None:
                    rec["evict"] = True
        self.generic_visit(node)

    def _note_cache_method_write(self, node) -> None:
        """``CACHE.setdefault(k, v)`` / ``CACHE.update(...)`` grow the
        cache as a subscript store does."""
        f = node.func
        if not (isinstance(f, ast.Attribute)
                and f.attr in ("setdefault", "update")):
            return
        name = self._is_cache_name(f.value)
        if name:
            self.cache_writes.setdefault(name, []).append(node.lineno)
            if f.attr == "setdefault" and node.args:
                self._check_cache_key(name, node.args[0], node.lineno)
            self._check_cache_write_guard(name, node.lineno)
            return
        rec = self._param_record(f.value)
        if rec is not None:
            if rec["write"] is None:
                rec["write"] = node.lineno
            if f.attr == "setdefault" and node.args:
                rec["keyhaz"].extend(
                    self._key_hazards(node.args[0], node.lineno))

    def _key_hazards(self, key, lineno: int) -> list:
        for n in ast.walk(key):
            if isinstance(n, (ast.List, ast.ListComp, ast.Set, ast.SetComp,
                              ast.Dict, ast.DictComp)):
                return [(lineno, type(n).__name__)]
        return []

    def _check_cache_key(self, name: str, key, lineno: int) -> None:
        for lineno, tname in self._key_hazards(key, lineno):
            self._emit("cache-key-list", "error",
                       f"raw {tname} in {name} key: unhashable and "
                       "unbounded as a cache key", lineno)

    def _resolve_cache_aliases(self) -> None:
        """Join the call sites that pass a module ``*_CACHE`` with the
        callee's parameter use: writes, evictions and key hazards through
        the alias count against the module cache."""
        emitted: set = set()
        for callee, pos, cname in self.cache_arg_calls:
            info = self.fn_param_use.get(callee)
            if info is None:
                continue
            params, records = info
            pname = pos if isinstance(pos, str) else (
                params[pos] if pos < len(params) else None)
            rec = records.get(pname)
            if rec is None:
                continue
            if rec["write"] is not None:
                self.cache_writes.setdefault(cname, []).append(rec["write"])
            if rec["evict"]:
                self.cache_evictions.add(cname)
            for lineno, tname in rec["keyhaz"]:
                if (lineno, cname) in emitted:
                    continue
                emitted.add((lineno, cname))
                self.scope_stack = ["<module>", rec["scope"]]
                self._emit("cache-key-list", "error",
                           f"raw {tname} in {cname} key (through parameter "
                           f"{pname!r} of {callee}()): unhashable and "
                           "unbounded as a cache key", lineno)

    def finish(self) -> None:
        self._resolve_cache_aliases()
        for name in sorted(self.module_caches):
            writes = self.cache_writes.get(name)
            if writes and name not in self.cache_evictions:
                self.scope_stack = ["<module>"]
                self._emit("unbounded-cache", "warning",
                           f"{name} grows without eviction (no len() "
                           "guard or pop/popitem/clear in module)",
                           writes[0])


def lint_source(source: str, rel: str) -> list:
    """The findings of one module's source, named ``rel``."""
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding(rel, "<module>", "syntax-error", "error", str(e),
                        e.lineno or 0)]
    lint = _Lint(rel, source, tree)
    lint.visit(tree)
    lint.finish()
    return lint.findings


def lint_file(path: str, rel: str | None = None) -> list:
    with open(path) as f:
        source = f.read()
    return lint_source(source, rel or path)


def lint_tree(root: str | None = None) -> list:
    """Lint every ``.py`` file under ``nds_tpu_torch/`` (or ``root``);
    findings are named by their path relative to the root's parent."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    repo = os.path.dirname(os.path.abspath(root))
    findings: list = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "_build"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                p = os.path.join(dirpath, fn)
                findings.extend(lint_file(p, os.path.relpath(p, repo)))
    return findings
