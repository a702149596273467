"""host-sync: no host synchronization inside the device loop.

On the card every torch op is queued on a stream and the host runs ahead.
A read of a device value on the host (``.item()``, ``bool(t)``, ...)
stops the host until the card has drained the queue, so inside a loop it
costs one round trip and one empty queue per iteration: the solver's
Frank-Wolfe steps, the packet engine's cycles and the certified engine's
chunks are written to read nothing back until the end, and
``chip_smoke.py`` runs them under ``torch.cuda.set_sync_debug_mode
("error")``.

The reference's "jit-reachable" becomes the torch *device loop*.  A sync
form counts when it sits

(a) lexically inside the body or test of a ``for`` / ``while`` loop or a
    comprehension (a nested ``def`` starts outside any loop), or
(b) anywhere in a per-step function: one named ``*_step``, ``step``,
    ``cycle`` or ``chunk`` (``decode_step``, ``train_step``,
    ``_BatchedRun.cycle``, the certified engine's ``chunk``),

outside any function named ``*_reference*``.  The sync forms:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``;
* ``np.asarray(...)`` / ``np.array(...)``;
* ``bool()`` / ``float()`` / ``int()`` of a value that may be a tensor;
* an ``if`` / ``while`` / ``assert`` test that calls ``.any()`` /
  ``.all()``;
* ``torch.equal``;
* ``torch.nonzero`` / ``.nonzero()``, ``torch.unique`` / ``.unique()``,
  ``masked_select``, and one-argument ``torch.where`` (their output size
  is read back);
* ``F.one_hot`` without ``num_classes`` (it reads the index range back);
* ``torch.cuda.synchronize()``.

Detection is a deliberate, documented approximation: the rule knows no
types, so it keeps a conservative account of which names hold *host*
values, and a form whose operand it cannot show to be host counts.  Host
values are constants; shape-like reads (``.shape``, ``.ndim``,
``.dtype``, ``.device``, ``len()``, ``.numel()``, ``.size()``,
``.dim()``) -- the counterpart of the reference's static reads under
tracing; names bound by ``for ... in range(...)``; parameters annotated
as Python scalars, strings, ``np.ndarray`` or containers of them (the
counterpart of ``static_argnames``); the results of ``numpy`` / ``math``
calls and of ``int()`` / ``float()`` / ``len()``; ``self`` / ``cls`` and
attributes read through them; and names whose every binding in their
scope is host.  So a receiver that is a numpy array (``arr.tolist()``)
does not count, and neither does ``int(t >= self.switch)`` in a loop over
``range``.  Blind spots, by design: a function *called* from a loop is not
followed (its own loops and its name still count); a tensor held on
``self`` and read with ``float(self.x)``; and an implicit ``if t:`` on a
tensor.  ``.item()`` and the other method forms still catch most of them.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ..report import Finding
from .base import FileContext, Rule, keyword, method_name

_STEP_FN = re.compile(r"^(?:\w*_step|step|cycle|chunk)$")
_EXEMPT_FN = re.compile(r"_reference")
_NP_HOST = {"numpy.asarray", "numpy.array"}
_SHAPE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad"}
# methods whose result is a Python value (the sync ones are reported
# on their own)
_HOST_METHODS = {"numel", "size", "dim", "nelement", "element_size",
                 "stride", "is_contiguous", "data_ptr", "get_device",
                 "item", "tolist", "cpu", "numpy"}
_HOST_BUILTINS = {"len", "int", "float", "bool", "str", "repr", "range",
                  "isinstance", "issubclass", "hasattr", "callable", "id",
                  "type", "format", "ord", "chr"}
# builtins whose result is host when their arguments are
_PURE_BUILTINS = {"min", "max", "abs", "round", "sum", "divmod", "pow",
                  "tuple", "list", "sorted", "reversed", "zip", "enumerate",
                  "dict", "set", "frozenset", "any", "all", "iter", "next"}
_HOST_TORCH = {"torch.device", "torch.Size", "torch.finfo", "torch.iinfo",
               "torch.is_tensor", "torch.is_grad_enabled",
               "torch.get_default_dtype", "torch.cuda.is_available",
               "torch.cuda.device_count"}
_HOST_MODULES = ("numpy", "math", "time", "os", "json", "itertools")
_HOST_TYPES = {"int", "float", "bool", "str", "bytes", "complex", "None",
               "numpy.ndarray", "numpy.integer", "numpy.floating",
               "numpy.random.Generator", "numpy.random.RandomState",
               "torch.device", "torch.dtype"}
_CONTAINERS = {"Optional", "Union", "Tuple", "List", "Sequence", "tuple",
               "list", "Dict", "dict", "Mapping", "Iterable", "Set",
               "FrozenSet", "typing.Optional", "typing.Union",
               "typing.Tuple", "typing.List", "typing.Sequence",
               "typing.Dict"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SIZE_METHODS = {"nonzero", "unique", "masked_select"}
_SIZE_TORCH = {"torch.nonzero", "torch.unique", "torch.masked_select"}
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_COMPS = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)


def _is_host_annotation(ann: Optional[ast.AST], ctx: FileContext) -> bool:
    """An annotation naming a Python scalar, a string, ``np.ndarray``,
    ``torch.device`` / ``torch.dtype`` or a container / union of them."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant):
        return ann.value is None
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return (_is_host_annotation(ann.left, ctx)
                and _is_host_annotation(ann.right, ctx))
    if isinstance(ann, ast.Subscript):
        base = ctx.dotted(ann.value)
        if base not in _CONTAINERS:
            return False
        args = (ann.slice.elts if isinstance(ann.slice, ast.Tuple)
                else [ann.slice])
        return all(isinstance(a, ast.Constant) and a.value is Ellipsis
                   or _is_host_annotation(a, ctx) for a in args)
    return ctx.dotted(ann) in _HOST_TYPES


class _Scopes:
    """Which names hold host values, per function scope.

    Every binding of a name in a scope (assignment, loop target,
    parameter, import, def) is recorded with the expression it binds; a
    name is host when all its bindings are, computed to a fixed point
    from the optimistic start (so ``i = 0 ... i += 1`` stays host)."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        # scope node -> name -> list of binding thunks
        self.bindings: Dict[int, Dict[str, list]] = {}
        self.scope_of: Dict[int, ast.AST] = {}
        self._collect(ctx.tree, ctx.tree)
        self.host: Dict[Tuple[int, str], bool] = {
            (sid, n): True for sid, names in self.bindings.items()
            for n in names}
        changed = True
        while changed:
            changed = False
            for sid, names in self.bindings.items():
                for n, binds in names.items():
                    if self.host[(sid, n)] and not all(
                            b() for b in binds):
                        self.host[(sid, n)] = False
                        changed = True

    # ------------------------------------------------------------ binding

    def _bind(self, scope: ast.AST, name: str, thunk) -> None:
        self.bindings.setdefault(id(scope), {}).setdefault(
            name, []).append(thunk)

    def _bind_target(self, scope, target, value: Optional[ast.AST],
                     host=None) -> None:
        """Bind the names of an assignment target to `value` (elementwise
        through a tuple of the same arity); `host` overrides."""
        if isinstance(target, ast.Name):
            if host is not None:
                self._bind(scope, target.id, lambda h=host: h)
            elif value is None:
                self._bind(scope, target.id, lambda: False)
            else:
                self._bind(scope, target.id,
                           lambda v=value, s=scope: self.is_host(v, s))
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = (value.elts if isinstance(value, (ast.Tuple, ast.List))
                    and len(value.elts) == len(target.elts) else None)
            for i, t in enumerate(target.elts):
                self._bind_target(scope, t, vals[i] if vals else value,
                                  host)
        elif isinstance(target, ast.Starred):
            self._bind_target(scope, target.value, value, host)

    def _bind_loop(self, scope, target, it: ast.AST) -> None:
        """A loop target: host over ``range``, over a host iterable, and
        the index of ``enumerate``; element-wise through ``zip``."""
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
            fname = it.func.id
            if fname == "range":
                self._bind_target(scope, target, None, host=True)
                return
            if (fname == "enumerate" and it.args
                    and isinstance(target, ast.Tuple)
                    and len(target.elts) == 2):
                self._bind_target(scope, target.elts[0], None, host=True)
                self._bind_loop(scope, target.elts[1], it.args[0])
                return
            if (fname == "zip" and isinstance(target, ast.Tuple)
                    and len(target.elts) == len(it.args)):
                for t, a in zip(target.elts, it.args):
                    self._bind_loop(scope, t, a)
                return
        self._bind_target(scope, target, it)

    def _collect(self, node: ast.AST, scope: ast.AST) -> None:
        ctx = self.ctx
        for child in ast.iter_child_nodes(node):
            self.scope_of[id(child)] = scope
            inner = scope
            if isinstance(child, _FUNCS):
                if not isinstance(child, ast.Lambda):
                    self._bind(scope, child.name, lambda: True)
                    # "f()": what a call of f returns or yields (None
                    # when it returns nothing)
                    self._bind(scope, child.name + "()", lambda: True)
                    for v in _returned(child):
                        self._bind(scope, child.name + "()",
                                   lambda v=v, f=child: self.is_host(v, f))
                inner = child
                a = child.args
                params = (list(a.posonlyargs) + list(a.args)
                          + list(a.kwonlyargs))
                for i, p in enumerate(params):
                    host = (p.arg in ("self", "cls") and i == 0
                            or _is_host_annotation(p.annotation, ctx))
                    self._bind(child, p.arg, lambda h=host: h)
                for p in (a.vararg, a.kwarg):
                    if p is not None:
                        self._bind(child, p.arg, lambda: False)
            elif isinstance(child, ast.ClassDef):
                self._bind(scope, child.name, lambda: True)
            elif isinstance(child, (ast.Import, ast.ImportFrom)):
                for al in child.names:
                    self._bind(scope, (al.asname or al.name).split(".")[0],
                               lambda: True)
            elif isinstance(child, ast.Assign):
                for t in child.targets:
                    self._bind_target(scope, t, child.value)
            elif isinstance(child, ast.AnnAssign):
                if _is_host_annotation(child.annotation, ctx):
                    self._bind_target(scope, child.target, None, host=True)
                elif child.value is not None:
                    self._bind_target(scope, child.target, child.value)
            elif isinstance(child, ast.AugAssign):
                if isinstance(child.target, ast.Name):
                    self._bind_target(scope, child.target, ast.BinOp(
                        left=ast.Name(id=child.target.id, ctx=ast.Load()),
                        op=child.op, right=child.value))
            elif isinstance(child, ast.NamedExpr):
                self._bind_target(scope, child.target, child.value)
            elif isinstance(child, (ast.For, ast.AsyncFor)):
                self._bind_loop(scope, child.target, child.iter)
            elif isinstance(child, ast.comprehension):
                self._bind_loop(scope, child.target, child.iter)
            elif isinstance(child, ast.withitem):
                if child.optional_vars is not None:
                    self._bind_target(scope, child.optional_vars, None)
            elif isinstance(child, ast.ExceptHandler) and child.name:
                self._bind(scope, child.name, lambda: True)
            self._collect(child, inner)

    # ------------------------------------------------------------- lookup

    def _name_host(self, name: str, scope: ast.AST,
                   unbound: bool = True) -> bool:
        """`name` as seen from `scope`; `unbound` for a name no scope of
        the file binds (a builtin)."""
        cur = scope
        while True:
            if name in self.bindings.get(id(cur), {}):
                return self.host[(id(cur), name)]
            if cur is self.ctx.tree:
                return unbound
            cur = self.scope_of.get(id(cur), self.ctx.tree)

    def is_host(self, node: ast.AST, scope: ast.AST) -> bool:
        """True when `node` can be shown to hold a host value."""
        if isinstance(node, (ast.Constant, ast.JoinedStr, ast.Lambda)):
            return True
        if isinstance(node, ast.Name):
            return self._name_host(node.id, scope)
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                return True
            return self.is_host(node.value, scope)
        if isinstance(node, ast.Subscript):
            return self.is_host(node.value, scope)
        if isinstance(node, ast.Call):
            return self._call_host(node, scope)
        if isinstance(node, ast.Starred):
            return self.is_host(node.value, scope)
        if isinstance(node, ast.NamedExpr):
            return self.is_host(node.value, scope)
        if isinstance(node, _COMPS):
            elts = ([node.key, node.value] if isinstance(node, ast.DictComp)
                    else [node.elt])
            return all(self.is_host(e, scope) for e in elts)
        if isinstance(node, ast.Slice):
            return all(self.is_host(e, scope)
                       for e in (node.lower, node.upper, node.step) if e)
        if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.BoolOp,
                             ast.Compare, ast.IfExp, ast.Tuple, ast.List,
                             ast.Set, ast.Dict)):
            return all(self.is_host(c, scope)
                       for c in ast.iter_child_nodes(node)
                       if not isinstance(c, (ast.operator, ast.unaryop,
                                             ast.boolop, ast.cmpop,
                                             ast.expr_context)))
        return False

    def _call_host(self, node: ast.Call, scope: ast.AST) -> bool:
        ctx = self.ctx
        f = node.func
        fq = ctx.dotted(f) or ""
        if isinstance(f, ast.Name):
            if f.id in _HOST_BUILTINS:
                return True
            if f.id in _PURE_BUILTINS:
                return all(self.is_host(a, scope) for a in node.args)
            # a function of this file: host when all it returns is
            return self._name_host(f.id + "()", scope, unbound=False)
        if fq in _HOST_TORCH:
            return True
        if fq.split(".")[0] in _HOST_MODULES:
            return True
        if isinstance(f, ast.Attribute):
            if f.attr in _HOST_METHODS:
                return True
            recv = f.value
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
                return False  # the object's own methods: unknown
            if fq.startswith("torch."):
                return False
            return self.is_host(recv, scope)
        return False


def _returned(fn: ast.AST) -> Iterable[ast.AST]:
    """The values `fn` itself returns or yields (not its nested defs')."""
    stack = list(fn.body)
    while stack:
        n = stack.pop()
        if isinstance(n, _FUNCS + (ast.ClassDef,)):
            continue
        if isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)) \
                and n.value is not None:
            yield n.value
        stack.extend(ast.iter_child_nodes(n))


def _is_cpu(node: Optional[ast.AST], ctx: FileContext) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and ctx.dotted(node.func) == "torch.device" and bool(node.args)
            and _is_cpu(node.args[0], ctx))


class HostSyncRule(Rule):
    id = "host-sync"
    description = ("no .item()/.tolist()/.cpu()/bool()-on-tensor/"
                   "np.asarray/nonzero/.any() tests/torch.cuda.synchronize "
                   "inside the device loop (loop bodies and per-step "
                   "functions) -- each is a host round trip per iteration")

    def check(self, ctx: FileContext) -> List[Finding]:
        scopes = _Scopes(ctx)
        out: List[Finding] = []

        def report(node: ast.AST, msg: str) -> None:
            out.append(self.finding(ctx, node, msg))

        def visit(node: ast.AST, in_loop: bool, in_step: bool,
                  scope: ast.AST, test: bool) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if _EXEMPT_FN.search(node.name):
                    return
                for d in node.decorator_list:
                    visit(d, in_loop, in_step, scope, False)
                step = in_step or bool(_STEP_FN.match(node.name))
                for s in node.body:
                    visit(s, False, step, node, False)
                return
            if isinstance(node, ast.Lambda):
                visit(node.body, in_loop, in_step, node, False)
                return
            live = in_loop or in_step
            if live:
                self._check_node(ctx, scopes, node, scope, test, report)
            if isinstance(node, (ast.For, ast.AsyncFor)):
                visit(node.target, in_loop, in_step, scope, False)
                visit(node.iter, in_loop, in_step, scope, False)
                for s in node.body:
                    visit(s, True, in_step, scope, False)
                for s in node.orelse:
                    visit(s, in_loop, in_step, scope, False)
                return
            if isinstance(node, ast.While):
                visit(node.test, True, in_step, scope, True)
                for s in node.body:
                    visit(s, True, in_step, scope, False)
                for s in node.orelse:
                    visit(s, in_loop, in_step, scope, False)
                return
            if isinstance(node, (ast.If, ast.Assert)):
                visit(node.test, in_loop, in_step, scope, True)
                rest = ([node.msg] if isinstance(node, ast.Assert)
                        else node.body + node.orelse)
                for s in rest:
                    if s is not None:
                        visit(s, in_loop, in_step, scope, False)
                return
            if isinstance(node, _COMPS):
                gens = node.generators
                for i, g in enumerate(gens):
                    visit(g.iter, in_loop or i > 0, in_step, scope, False)
                    visit(g.target, True, in_step, scope, False)
                    for c in g.ifs:
                        visit(c, True, in_step, scope, False)
                elts = ([node.key, node.value]
                        if isinstance(node, ast.DictComp) else [node.elt])
                for e in elts:
                    visit(e, True, in_step, scope, False)
                return
            for child in ast.iter_child_nodes(node):
                visit(child, in_loop, in_step, scope, test)

        for stmt in ctx.tree.body:
            visit(stmt, False, False, ctx.tree, False)
        return out

    @staticmethod
    def _check_node(ctx: FileContext, scopes: _Scopes, node: ast.AST,
                    scope: ast.AST, test: bool, report) -> None:
        if not isinstance(node, ast.Call):
            return

        def host(e):
            return scopes.is_host(e, scope)

        fq = ctx.dotted(node.func)
        meth = method_name(node)
        recv = node.func.value if meth else None
        if test and meth in ("any", "all") and not host(recv):
            report(node, f".{meth}() in an if/while/assert test reads a "
                   "device bool back on the host each iteration")
        elif meth in _SYNC_METHODS and not host(recv):
            report(node, f".{meth}() in the device loop copies to the host "
                   "and waits for the card")
        elif (meth == "to" and not host(recv)
              and (_is_cpu(node.args[0] if node.args else None, ctx)
                   or _is_cpu(keyword(node, "device"), ctx))):
            report(node, '.to("cpu") in the device loop copies to the host '
                   "and waits for the card")
        elif fq in _NP_HOST and node.args and not host(node.args[0]):
            report(node, f"{ast.unparse(node.func)}() in the device loop "
                   "pulls a tensor to the host; keep it on the device")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in ("bool", "float", "int")
              and len(node.args) == 1 and not host(node.args[0])):
            arg = node.args[0]
            if (test and isinstance(arg, ast.Call)
                    and method_name(arg) in ("any", "all")):
                return  # the test form reports it once
            report(node, f"{node.func.id}() of a tensor in the device loop "
                   "is a host sync (shape reads and Python scalars are "
                   "fine)")
        elif fq == "torch.equal":
            report(node, "torch.equal returns a Python bool: a host sync "
                   "in the device loop")
        elif fq in _SIZE_TORCH or (meth in _SIZE_METHODS
                                   and not host(recv)):
            report(node, f"{ast.unparse(node.func)} has a data-dependent "
                   "output size, read back on the host")
        elif fq == "torch.where" and len(node.args) == 1 \
                and not node.keywords:
            report(node, "one-argument torch.where is nonzero: its output "
                   "size is read back on the host")
        elif (fq == "torch.nn.functional.one_hot" and len(node.args) < 2
              and keyword(node, "num_classes") is None):
            report(node, "F.one_hot without num_classes reads the index "
                   "range back on the host")
        elif fq == "torch.cuda.synchronize":
            report(node, "torch.cuda.synchronize() in the device loop "
                   "drains the queue every iteration")


def reached_lines(ctx: FileContext, roots: Iterable[str]) -> Set[int]:
    """The source lines that running the functions `roots` ("name" or
    "Class.method") can execute in this file: their bodies and those of
    every function of the file they call by name, transitively.  A
    function's nested defs count only where they are themselves called.
    A cross-check of the rule against a run under
    ``torch.cuda.set_sync_debug_mode("error")``: host-sync should report
    nothing on these lines."""
    defs: Dict[str, List[ast.AST]] = {}
    for fn in ctx.function_defs():
        defs.setdefault(fn.name, []).append(fn)
        parent = ctx.parent(fn)
        if isinstance(parent, ast.ClassDef):
            defs.setdefault(f"{parent.name}.{fn.name}", []).append(fn)

    def own_nodes(fn):
        stack = list(ast.iter_child_nodes(fn))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    todo = [fn for r in roots for fn in defs.get(r, ())]
    if not todo:
        raise KeyError(f"none of {list(roots)} is defined in {ctx.path}")
    done: Set[int] = set()
    lines: Set[int] = set()
    while todo:
        fn = todo.pop()
        if id(fn) in done:
            continue
        done.add(id(fn))
        for n in own_nodes(fn):
            if isinstance(n, ast.stmt):
                lines.add(n.lineno)  # a compound one may hold nested defs
            elif isinstance(n, ast.expr):
                lines.update(range(n.lineno, n.end_lineno + 1))
            if isinstance(n, ast.Call):
                name = (n.func.id if isinstance(n.func, ast.Name)
                        else method_name(n))
                todo.extend(defs.get(name, ()))
    return lines
