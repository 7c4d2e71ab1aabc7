"""host-sync rule: device->host synchronisation in the wrong place.

Two flavors, as in the reference's rule:

* **in-hot** — a sync op inside a function reachable from the serving
  hot roots or from the captured train bodies: `.item()`, `.tolist()`,
  `.numpy()`, `.cpu()`, `.to("cpu")`, `np.asarray`/`np.array` of a
  tensor, `float()/int()/bool()` of a device value,
  `torch.cuda.synchronize`/`.synchronize()`, and the ops
  whose output shape depends on the data and which therefore sync on the
  card (`torch.nonzero`, `masked_select`, boolean-mask indexing,
  `torch.unique`, `repeat_interleave` without `output_size`).  Inside a
  CUDA-graph capture each breaks the capture; in the eager admission
  path each stalls the host on the card.
* **host-loop** — the same ops inside a `for`/`while` loop that also
  calls a captured function, a hot root or a graph replay.  Each
  iteration blocks on the device, serialising the loop.

Coercions (`float`/`int`/`bool`, `np.asarray`) are only flagged when the
argument *derives from a device computation* (assigned from a `torch.`
or `prng.` call or a captured/hot-root call, possibly through unpacking,
indexing or arithmetic) — `int(cfg.d_model * 4)` is static Python and
stays silent.  Inside hot functions, parameters count as device-derived
except static names (keyword-only parameters, parameters with a constant
default or an int/bool/float/str annotation, the graph variant keys)
and a small blocklist (`self`, `cfg`, `config`, `spec`).  A pull inside a `sync_region` body
is declared and exempt, except in a function a CUDA graph captures.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set

from ..lint import (
    Finding,
    FunctionInfo,
    ProjectIndex,
    Rule,
    call_base_name,
    dotted_name,
    dotted_root,
    static_params,
)
from . import register

_DEVICE_ROOTS = {"torch", "prng"}
_NP_ROOTS = {"np", "numpy", "onp"}
_NP_CONVERTERS = {"asarray", "array"}
_COERCIONS = {"float", "int", "bool"}
_STATIC_PARAM_BLOCKLIST = {"self", "cls", "cfg", "config", "spec", "mesh"}
# methods whose result lives on the host: a device value stops there
_HOST_RESULTS = {"item", "tolist", "numpy", "cpu"}
_PULL_METHODS = {
    "item": "`.item()` blocks on the device",
    "tolist": "`.tolist()` copies a tensor to the host",
    "numpy": "`.numpy()` copies a tensor to the host",
    "cpu": "`.cpu()` copies a tensor to the host",
}
# ops that size their output from the data: the card syncs to learn it
_DATA_SHAPED = {"nonzero", "argwhere", "masked_select", "unique",
                "unique_consecutive"}
_MASK_CALLS = {"isfinite", "isnan", "isinf", "logical_and", "logical_or",
               "logical_not", "logical_xor"}


def _device_vars(fi: FunctionInfo, jit_names: Set[str], params_device: bool,
                 static_names: Set[str], project: Set[str]) -> Set[str]:
    """Names in `fi` bound (transitively) to device-computation results."""
    dv: Set[str] = set()
    if params_device:
        for p in ast.walk(fi.node):
            if isinstance(p, ast.arguments):
                for a in list(p.posonlyargs) + list(p.args) + list(p.kwonlyargs):
                    if a.arg not in static_names and a.arg not in _STATIC_PARAM_BLOCKLIST:
                        dv.add(a.arg)
                break

    def mark(target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            dv.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                mark(e)
        elif isinstance(target, ast.Starred):
            mark(target.value)

    # two passes for simple forward chains (a = fwd(); b = a[0]; c = b + 1)
    for _ in range(2):
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and _is_device(node.value, dv, jit_names, project):
                for t in node.targets:
                    mark(t)
            elif isinstance(node, ast.AugAssign) and (
                    _is_device(node.value, dv, jit_names, project) or _is_device(node.target, dv, jit_names, project)):
                mark(node.target)
            elif isinstance(node, ast.For) and _is_device(node.iter, dv, jit_names, project):
                mark(node.target)
    return dv


def _is_device(node: ast.AST, dv: Set[str], jit_names: Set[str],
               project: Set[str] = frozenset()) -> bool:
    """Does this expression (syntactically) hold a device value?
    `project` names the scanned defs: one called with a device argument
    is taken to return a device value."""
    def dev(n: ast.AST) -> bool:
        return _is_device(n, dv, jit_names, project)

    if isinstance(node, ast.Name):
        return node.id in dv
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_RESULTS:
            return False  # the pull's result is host-side from here on
        if dotted_root(node.func) in _DEVICE_ROOTS:
            return True
        base = call_base_name(node)
        if base in jit_names:
            return True
        if base in project and any(dev(a) for a in node.args):
            return True
        # method call on a device value: x.to(...), x.sum()
        if isinstance(node.func, ast.Attribute):
            return dev(node.func.value)
        return False
    if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        if isinstance(node, ast.Attribute) and node.attr in ("shape", "ndim", "dtype", "device"):
            return False  # metadata lives on the host
        return dev(node.value)
    if isinstance(node, ast.BinOp):
        return dev(node.left) or dev(node.right)
    if isinstance(node, ast.UnaryOp):
        return dev(node.operand)
    if isinstance(node, ast.Compare):
        return dev(node.left) or any(dev(c) for c in node.comparators)
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(dev(e) for e in node.elts)
    if isinstance(node, ast.IfExp):
        return dev(node.body) or dev(node.orelse)
    return False


class _SyncOp:
    """A sync op; `operands` decide it when `needs_device_arg`."""

    def __init__(self, node: ast.AST, what: str, needs_device_arg: bool,
                 operands: List[ast.AST] = ()) -> None:
        self.node = node
        self.what = what
        self.needs_device_arg = needs_device_arg
        self.operands = list(operands)


def _is_cpu_target(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) in ("torch.device", "device"):
        return bool(node.args) and _is_cpu_target(node.args[0])
    return False


def _mask_expr(node: ast.AST, masks: Set[str]) -> bool:
    """Does this index expression (syntactically) build a boolean mask?"""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _mask_expr(node.left, masks) or _mask_expr(node.right, masks)
    if isinstance(node, ast.Call):
        return call_base_name(node) in _MASK_CALLS
    if isinstance(node, ast.Name):
        return node.id in masks
    return False


def _mask_names(fn: ast.AST) -> Set[str]:
    masks: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _mask_expr(node.value, masks):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    masks.add(t.id)
    return masks


def _sync_ops(body: ast.AST, masks: Set[str]) -> List[_SyncOp]:
    out: List[_SyncOp] = []
    for node in ast.walk(body):
        if isinstance(node, ast.Subscript) and _mask_expr(node.slice, masks):
            out.append(_SyncOp(
                node, "boolean-mask indexing sizes its result from the data "
                "(a nonzero that syncs on the card)", True, [node.value, node.slice]))
            continue
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        root = dotted_root(node.func)
        if isinstance(node.func, ast.Attribute) and root not in _NP_ROOTS:
            attr = node.func.attr
            if attr in _PULL_METHODS and not node.args:
                out.append(_SyncOp(node, _PULL_METHODS[attr], False))
                continue
            if attr == "to" and any(_is_cpu_target(a) for a in
                                    list(node.args) + [k.value for k in node.keywords
                                                       if k.arg == "device"]):
                out.append(_SyncOp(node, "`.to(\"cpu\")` copies a tensor to the host", False))
                continue
            if attr == "synchronize":
                what = ("`torch.cuda.synchronize` is an explicit device barrier"
                        if name == "torch.cuda.synchronize"
                        else "`.synchronize()` is an explicit device barrier")
                out.append(_SyncOp(node, what, False))
                continue
            if attr in _DATA_SHAPED:
                out.append(_SyncOp(node, f"`{attr}` sizes its output from the data "
                                   "— a hidden sync on the card", False))
                continue
            if attr == "repeat_interleave" and not any(
                    k.arg == "output_size" for k in node.keywords):
                out.append(_SyncOp(node, "`repeat_interleave` without `output_size` "
                                   "sizes its output from the data — a hidden sync "
                                   "on the card", False))
                continue
        if (
            root in _NP_ROOTS
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _NP_CONVERTERS
            and node.args
        ):
            out.append(_SyncOp(node, f"`{root}.{node.func.attr}` on a tensor copies to host",
                               True, node.args))
            continue
        if (
            isinstance(node.func, ast.Name)
            and node.func.id in _COERCIONS
            and len(node.args) == 1
        ):
            out.append(_SyncOp(node, f"`{node.func.id}()` on a device value forces a host sync",
                               True, node.args))
    return out


def _declared_sync_nodes(fi: FunctionInfo) -> Set[ast.AST]:
    """AST nodes inside `with ...sync_region(tag):` blocks.

    A pull wrapped in `repro_torch.analysis.runtime.sync_region` is a
    *declared* blocking boundary — counted at runtime, and exempt here.
    """
    out: Set[ast.AST] = set()
    for node in ast.walk(fi.node):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            ce = item.context_expr
            if isinstance(ce, ast.Call) and call_base_name(ce) == "sync_region":
                for stmt in node.body:
                    out.update(ast.walk(stmt))
                break
    return out


def _loops_with_jit_calls(fi: FunctionInfo, jit_names: Set[str]) -> List[ast.AST]:
    loops = []
    for node in ast.walk(fi.node):
        if isinstance(node, (ast.For, ast.While)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and call_base_name(sub) in jit_names:
                    loops.append(node)
                    break
    return loops


@register
class HostSyncRule(Rule):
    name = "host-sync"
    doc = (
        "Device->host sync ops (.item(), .tolist(), .numpy(), .cpu(), "
        ".to('cpu'), np.asarray, float/int/bool coercions, synchronize, "
        "data-shaped ops) inside hot-path functions or inside host loops "
        "that call captured functions."
    )

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        jit_names = index.jit_names()
        project = set(index.defs_by_name)
        static_by_fn: Dict[str, Set[str]] = {
            ji.name: set(ji.static_argnames)
            | {ji.params[i] for i in ji.static_argnums if i < len(ji.params)}
            for ji in index.jits_by_name.values()
        }
        for mod in index.modules:
            for fi in mod.functions:
                masks = _mask_names(fi.node)
                declared = (set() if fi.name in index.captured_functions
                            else _declared_sync_nodes(fi))
                hot = index.is_hot(fi)
                if hot or index.is_train_captured(fi):
                    where = ("reachable from the serving hot roots" if hot else
                             "reachable from the captured train bodies")
                    dv = _device_vars(
                        fi, jit_names, params_device=True,
                        static_names=static_by_fn.get(fi.name, set())
                        | set(static_params(fi.node)), project=project,
                    )
                    for op in _sync_ops(fi.node, masks):
                        if op.node in declared:
                            continue
                        if op.needs_device_arg and not any(
                                _is_device(a, dv, jit_names, project) for a in op.operands):
                            continue
                        yield Finding(
                            rule=self.name, path=mod.path,
                            line=op.node.lineno, col=op.node.col_offset,
                            symbol=fi.qualname,
                            message=f"{op.what} in hot-path function `{fi.name}` "
                            f"({where})",
                        )
                else:
                    dv = _device_vars(fi, jit_names, params_device=False,
                                      static_names=set(), project=project)
                    for loop in _loops_with_jit_calls(fi, jit_names):
                        for op in _sync_ops(loop, masks):
                            if op.node in declared:
                                continue
                            if op.needs_device_arg and not any(
                                    _is_device(a, dv, jit_names, project) for a in op.operands):
                                continue
                            yield Finding(
                                rule=self.name, path=mod.path,
                                line=op.node.lineno, col=op.node.col_offset,
                                symbol=fi.qualname,
                                message=f"{op.what} inside a host loop that calls "
                                f"captured functions — one blocking round-trip per iteration",
                            )
