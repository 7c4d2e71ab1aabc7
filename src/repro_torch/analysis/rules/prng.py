"""prng-reuse rule: a threefry key used more than its one allowed time.

The port's `repro_torch.prng` is threefry, bit-identical to `jax.random`,
so the reference's single-use key discipline holds unchanged: consume a
key with exactly one sampling call, or derive children with
`split`/`fold_in` — never both, never twice.  Violations tracked per
function, per key variable:

* consumed by two calls without an interleaving reassignment
  (`key, sub = prng.split(key)` resets the state);
* consumed *and* used as a `split`/`fold_in` parent — the child keys
  are then correlated with the stream the consumer already drew from
  (the bug class the reference's serve.py once had);
* consumed inside a loop while defined outside it — every iteration
  draws the same stream.

Key variables are recognised from `prng.PRNGKey`/`split`/`fold_in`
results, a key moved or copied (`key.to(...)`, `.clone()`), and
parameters named like keys (`key`, `rng`, `*_key`, `*_rng`).
Consumers are `prng.uniform`/`gumbel`/`categorical`/`bits`, the model's
sampling helpers that take a key (`_select_token`, `_select_token_rows`)
and any other call the key is passed to, except the torch/numpy
functions that only select or reshape it.  A consumer that hands back
the advanced key (`tok, rng = _select_token(logits, rng, ...)`) may
run in a loop: each iteration draws from the key the last one returned.
Subscripted keys (`keys[i]`) are not tracked — the indexing itself is
the discipline.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Set, Tuple

from ..lint import Finding, FunctionInfo, ProjectIndex, Rule, dotted_name
from . import register

_DERIVERS = {"prng.split", "prng.fold_in", "repro_torch.prng.split",
             "repro_torch.prng.fold_in"}
_KEY_MAKERS = {"prng.PRNGKey", "repro_torch.prng.PRNGKey", "PRNGKey"}
# a key moved, cast or copied is the same key
_KEY_METHODS = {"to", "clone", "contiguous", "long"}
_NON_CONSUMING = {"print", "len", "repr", "str", "type", "id", "isinstance",
                  "to_uint32_words", "from_uint32_words"}
# No torch/np function draws randomness — a key passed through
# torch.where/stack/as_tensor is selected or reshaped, not consumed.
_NON_CONSUMING_ROOTS = {"torch", "np", "numpy"}


def _is_keyish_param(name: str) -> bool:
    return name in ("key", "rng") or name.endswith("_key") or name.endswith("_rng") or name.startswith("key_")


def _key_expr(node: ast.AST, keys: Set[str]) -> bool:
    """Does this expression produce a PRNG key (syntactically)?"""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if (isinstance(node.func, ast.Attribute) and node.func.attr in _KEY_METHODS
                and _key_expr(node.func.value, keys)):
            return True
        return name in _KEY_MAKERS or name in _DERIVERS
    if isinstance(node, ast.Name):
        return node.id in keys
    if isinstance(node, ast.IfExp):
        return _key_expr(node.body, keys) or _key_expr(node.orelse, keys)
    if isinstance(node, ast.Subscript):
        return _key_expr(node.value, keys)
    return False


def _target_names(targets: List[ast.AST]) -> Set[str]:
    out: Set[str] = set()
    for t in targets:
        for sub in ast.walk(t):
            if isinstance(sub, ast.Name):
                out.add(sub.id)
    return out


def _terminates(body: List[ast.stmt]) -> bool:
    """Does this branch body unconditionally leave the function?"""
    return bool(body) and isinstance(body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


@dataclass
class _KeyState:
    consumes: List[ast.Call] = field(default_factory=list)
    derives: List[ast.Call] = field(default_factory=list)
    loop_depth_at_def: int = 0


class _FnWalker:
    """Sequential walk of a function body tracking per-key use counts."""

    def __init__(self, fi: FunctionInfo) -> None:
        self.fi = fi
        self.env: Dict[str, _KeyState] = {}
        self.violations: List[Tuple[ast.Call, str]] = []
        self.depth = 0
        node = fi.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for a in list(node.args.args) + list(node.args.kwonlyargs):
                if _is_keyish_param(a.arg):
                    self.env[a.arg] = _KeyState()

    # -- events ----------------------------------------------------------
    def _use(self, var: str, call: ast.Call, derive: bool,
             advancing: bool = False) -> None:
        st = self.env.get(var)
        if st is None:
            return
        if derive:
            if st.consumes:
                self.violations.append(
                    (call, f"key `{var}` already consumed, now used as split/fold_in parent "
                           f"— child keys correlate with the consumed stream")
                )
            st.derives.append(call)
        else:
            if st.consumes:
                self.violations.append(
                    (call, f"key `{var}` consumed twice without an interleaving split/fold_in")
                )
            elif st.derives:
                self.violations.append(
                    (call, f"key `{var}` used as split/fold_in parent and then consumed "
                           f"— consumer stream overlaps the derived children")
                )
            elif self.depth > st.loop_depth_at_def and not advancing:
                self.violations.append(
                    (call, f"key `{var}` consumed inside a loop but defined outside it "
                           f"— every iteration draws the same stream")
                )
            st.consumes.append(call)

    def _bind(self, target: ast.AST, keyish: bool) -> None:
        if isinstance(target, ast.Name):
            if keyish:
                self.env[target.id] = _KeyState(loop_depth_at_def=self.depth)
            else:
                self.env.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._bind(e, keyish)

    # -- expression scan: find key args fed to calls ---------------------
    def _scan_expr(self, node: ast.AST, rebinds: Set[str] = frozenset()) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = dotted_name(sub.func)
            if name and name.split(".")[-1] in _NON_CONSUMING:
                continue
            derive = name in _DERIVERS
            if not derive and name and name.split(".")[0] in _NON_CONSUMING_ROOTS:
                continue
            for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                if isinstance(arg, ast.Name) and arg.id in self.env:
                    self._use(arg.id, sub, derive,
                              advancing=sub is node and arg.id in rebinds)

    # -- statements ------------------------------------------------------
    def walk(self, stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign):
            # `tok, rng = consumer(logits, rng)`: the call advances `rng`
            self._scan_expr(stmt.value, _target_names(stmt.targets))
            is_key = _key_expr(stmt.value, set(self.env))
            for t in stmt.targets:
                self._bind(t, is_key)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._scan_expr(stmt.value)
            self._bind(stmt.target, _key_expr(stmt.value, set(self.env)))
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter)
            self._bind(stmt.target, _key_expr(stmt.iter, set(self.env)))
            self.depth += 1
            self.walk(stmt.body)
            self.depth -= 1
            self.walk(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self._scan_expr(stmt.test)
            self.depth += 1
            self.walk(stmt.body)
            self.depth -= 1
            self.walk(stmt.orelse)
        elif isinstance(stmt, ast.If):
            self._scan_expr(stmt.test)
            # branches are exclusive: evaluate each against a copy, merge
            # max — unless the branch terminates (return/raise), in which
            # case the fall-through path never sees its key uses
            # (`if kind == "a": return init_a(key)` chains).
            import copy as _copy

            before = {k: _copy.deepcopy(v) for k, v in self.env.items()}
            self.walk(stmt.body)
            after_body = self.env
            self.env = before
            self.walk(stmt.orelse)
            if not _terminates(stmt.body):
                for k, st in after_body.items():
                    cur = self.env.get(k)
                    if cur is None or len(st.consumes) > len(cur.consumes) or len(st.derives) > len(cur.derives):
                        self.env[k] = st
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            pass  # nested defs get their own FunctionInfo walk
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr)
            self.walk(stmt.body)
        elif isinstance(stmt, ast.Try):
            self.walk(stmt.body)
            for h in stmt.handlers:
                self.walk(h.body)
            self.walk(stmt.orelse)
            self.walk(stmt.finalbody)
        elif isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self._scan_expr(stmt.value)
        else:
            self._scan_expr(stmt)


@register
class PrngReuseRule(Rule):
    name = "prng-reuse"
    doc = (
        "A threefry key consumed twice, consumed and re-used as a "
        "split/fold_in parent, or consumed in a loop it was defined "
        "outside of."
    )

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        for mod in index.modules:
            for fi in mod.functions:
                if not isinstance(fi.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                w = _FnWalker(fi)
                w.walk(fi.node.body)
                for call, msg in w.violations:
                    yield Finding(
                        rule=self.name, path=mod.path,
                        line=call.lineno, col=call.col_offset,
                        symbol=fi.qualname, message=msg,
                    )
