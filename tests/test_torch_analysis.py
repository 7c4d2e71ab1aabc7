"""The port's analyzer (``repro_torch.analysis``) against the reference's.

* Framework parity: one fixture tree of plain Python (hot-root names,
  calls, suppression comments, a baseline file) and a test-local rule
  that flags every call named ``sync_me`` go through
  ``repro.analysis.lint`` and ``repro_torch.analysis.lint``: equal hot
  sets, suppressions, finding keys and baseline diffs.
* Rule fixtures: each of the reference's fixture tests
  (``tests/test_analysis.py``) as a torch snippet that the port's rule
  fires on, and a clean counterpart it stays silent on.
* Tooling: suppression, rule toggles, baseline, stale entries, line-free
  keys and the CLI's exit codes.
* The sweep: the port's tree lints clean against its own baseline.
"""
import json
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint
from repro_torch.analysis.__main__ import main as cli
from repro_torch.analysis.rules import all_rules, rule_names
from repro_torch.analysis.rules.kernels import launch_symbols

REPO_ROOT = Path(__file__).resolve().parents[1]


def _scan(tmp_path, source, enabled=None):
    """Lint one fixture module; returns (findings, inline_suppressed)."""
    f = tmp_path / "fixture.py"
    f.write_text(textwrap.dedent(source))
    index = lint.build_index(tmp_path, [tmp_path])
    enabled_set = {enabled} if isinstance(enabled, str) else enabled
    return lint.run_rules(index, all_rules(), enabled=enabled_set)


def _rules_hit(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# framework parity with the reference
# ---------------------------------------------------------------------------

PARITY_TREE = {
    "serving/engine.py": """
        def lm_prefill(params, caches, batch, cfg):
            return _helper(batch)

        def _helper(x):
            sync_me(x)
            return _inner(x)

        def _inner(x):
            sync_me(x)  # lint: ignore[test-sync]
            return x

        def _decode_chunk(tok, ticks):
            for _ in range(ticks):
                tok = lm_decode(tok)
            return sync_me(tok)  # lint: ignore

        def cold(x):
            sync_me(x)
            return sync_me(x)
        """,
    "models/stack.py": """
        def lm_decode(tok):
            return _step(tok)

        def _step(tok):
            sync_me(tok)  # lint: ignore[other-rule]
            return tok

        class Model:
            def lm_generate(self, tok):
                return self._loop(tok)

            def _loop(self, tok):
                return sync_me(tok)

            def unrelated(self):
                sync_me(None)
        """,
    "tools/report.py": """
        def main():
            sync_me(1)
            return cold(2)
        """,
}


def _parity_run(pkg, root):
    """(hot defs, findings, n suppressed, baseline diff) of the fixture
    tree through one package's framework with a rule flagging every
    call named ``sync_me``."""
    import ast

    class SyncMe(pkg.Rule):
        name = "test-sync"

        def check(self, index):
            for mod in index.modules:
                for fi in mod.functions:
                    for node in ast.walk(fi.node):
                        if isinstance(node, ast.Call) and pkg.call_base_name(node) == "sync_me":
                            yield pkg.Finding(
                                rule=self.name, path=mod.path, line=node.lineno,
                                col=node.col_offset, symbol=fi.qualname,
                                message=f"sync_me in `{fi.name}`")

    index = pkg.build_index(root, [root])
    hot = sorted(f"{m.path}::{fi.qualname}" for m in index.modules
                 for fi in m.functions if index.is_hot(fi))
    findings, suppressed = pkg.run_rules(index, [SyncMe()])
    baseline = pkg.load_baseline(root / "baseline.json")
    diff = pkg.diff_baseline(findings, baseline)
    return hot, findings, suppressed, diff


def test_framework_parity_with_reference(tmp_path):
    for rel, src in PARITY_TREE.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    # the baseline: two of today's findings (one of them twice) and a
    # fixed one, written by the reference's writer
    j_index = jlint.build_index(tmp_path, [tmp_path])
    import ast
    calls = []
    for mod in j_index.modules:
        for fi in mod.functions:
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call) and jlint.call_base_name(node) == "sync_me":
                    calls.append(jlint.Finding("test-sync", mod.path, node.lineno,
                                               node.col_offset, fi.qualname,
                                               f"sync_me in `{fi.name}`"))
    calls.sort(key=lambda f: (f.path, f.line))
    kept = [f for f in calls if f.symbol in ("cold", "Model.unrelated")]
    fixed = jlint.Finding("test-sync", "gone.py", 1, 0, "gone", "sync_me in `gone`")
    jlint.write_baseline(tmp_path / "baseline.json", kept + [fixed])

    j_hot, j_find, j_sup, j_diff = _parity_run(jlint, tmp_path)
    t_hot, t_find, t_sup, t_diff = _parity_run(lint, tmp_path)
    assert t_hot == j_hot
    assert {"serving/engine.py::_helper", "models/stack.py::Model._loop"} <= set(t_hot)
    assert "tools/report.py::main" not in t_hot
    assert t_sup == j_sup == 2
    assert [f.key() for f in t_find] == [f.key() for f in j_find]
    assert lint.unique_keys(t_find) == jlint.unique_keys(j_find)
    assert [f.format() for f in t_find] == [f.format() for f in j_find]
    assert [f.key() for f in t_diff.new] == [f.key() for f in j_diff.new]
    assert [f.key() for f in t_diff.known] == [f.key() for f in j_diff.known]
    assert t_diff.stale == j_diff.stale == [fixed.key()]
    assert len(t_diff.known) == 3


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------

def test_host_sync_in_hot_function_reachable_from_hot_root(tmp_path):
    """`.item()` two calls below lm_prefill is flagged via reachability."""
    findings, _ = _scan(tmp_path, """
        import torch

        def _helper(x):
            return _inner(x)

        def _inner(x):
            return x.item()

        def lm_prefill(params, caches, batch, cfg):
            return _helper(torch.ones(3))
        """, enabled="host-sync")
    assert len(findings) == 1
    assert findings[0].symbol == "_inner"
    assert ".item()" in findings[0].message


LOOP = """
    import numpy as np
    import torch
    from repro_torch.serving.graphs import PackedGraphs

    def fwd(packed, ticks, sampled):
        return packed * 2

    graphs = PackedGraphs(fwd, 8, torch.device("cuda"))

    def drive(xs, cfg, n):
        out = []
        for x in xs:
            y = graphs(x, 4, False)
            {op}
        return out
    """

# (statement inside the host loop, fires) — each sync op of the rule,
# and the clean counterpart that stays silent
LOOP_OPS = [
    ("out.append(np.asarray(y))", True),
    ("out.append(int(y[0]))", True),
    ("out.append(int(cfg.d_model * 4))", False),
    ("out.append(y.cpu())", True),
    ("out.append(y.tolist())", True),
    ("out.append(y.numpy())", True),
    ("out.append(y.to('cpu'))", True),
    ("out.append(y.to(torch.device('cpu')))", True),
    ("out.append(y.to(torch.float32))", False),
    ("torch.cuda.synchronize()", True),
    ("out.append(torch.nonzero(y))", True),
    ("out.append(y[y > 0])", True),
    ("out.append(y.masked_fill(y > 0, 0))", False),
    ("out.append(torch.unique(y))", True),
    ("out.append(y.repeat_interleave(2))", True),
    ("out.append(y.repeat_interleave(2, output_size=n))", False),
    ("out.append(bool(y.sum() > 0))", True),
]


@pytest.mark.parametrize("op,fires", LOOP_OPS, ids=[o for o, _ in LOOP_OPS])
def test_host_sync_host_loop_ops(tmp_path, op, fires):
    """Each sync op inside a loop that replays a captured chunk is
    flagged; int() on config scalars, a dtype cast, masked_fill and
    repeat_interleave with output_size are not."""
    findings, _ = _scan(tmp_path, LOOP.format(op=op), enabled="host-sync")
    assert len(findings) == int(fires), [f.format() for f in findings]
    if fires:
        assert findings[0].symbol == "drive" and "host loop" in findings[0].message


def test_host_sync_host_loop_flags_and_coercion_heuristic(tmp_path):
    """np.asarray + int() on captured results inside a host loop are
    flagged; int() on config scalars is not."""
    findings, _ = _scan(tmp_path, LOOP.format(op="""out.append(np.asarray(y))       # flagged
            n = int(y[0])                   # flagged
            m = int(cfg.d_model * 4)        # static python: silent"""),
        enabled="host-sync")
    assert len(findings) == 2
    assert all(f.symbol == "drive" for f in findings)


def test_host_sync_declared_sync_region_is_exempt(tmp_path):
    findings, _ = _scan(tmp_path, LOOP.format(op="""with sync_region("drive"):
                out.append(y.cpu().numpy())   # declared: exempt""").replace(
        "import numpy as np", "import numpy as np\nfrom repro_torch.analysis.runtime "
        "import sync_region"), enabled="host-sync")
    assert findings == []


def test_host_sync_static_names_not_device(tmp_path):
    """Keyword-only (static) parameters of a hot root are Python values."""
    findings, _ = _scan(tmp_path, """
        def _decode_chunk(tok, *, ticks):
            n = int(ticks) + 1        # static: silent
            m = float(tok)            # device param: flagged
            return tok * n * m
        """, enabled="host-sync")
    assert len(findings) == 1
    assert "`float()`" in findings[0].message


def test_host_sync_region_in_captured_function_still_flagged(tmp_path):
    """A declared region inside a function a CUDA graph captures is still
    a bug: the capture cannot hold a pull."""
    findings, _ = _scan(tmp_path, """
        from repro_torch.analysis.runtime import sync_region
        from repro_torch.serving.graphs import PackedGraphs

        def chunk(packed, ticks, sampled):
            with sync_region("chunk"):
                return packed.item()

        graphs = PackedGraphs(chunk, 8, "cuda")
        """, enabled="host-sync")
    assert len(findings) == 0      # chunk is captured but not hot...
    findings, _ = _scan(tmp_path, """
        from repro_torch.analysis.runtime import sync_region
        from repro_torch.serving.graphs import PackedGraphs

        def _decode_chunk(packed, *, ticks):
            with sync_region("chunk"):
                return packed.item()

        graphs = PackedGraphs(_decode_chunk, 8, "cuda")
        """, enabled="host-sync")
    assert len(findings) == 1      # ...a hot root that is captured is


# ---------------------------------------------------------------------------
# prng-reuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,message", [
    ("""
        def sample(key):
            a = prng.uniform(key, (3,))
            b = prng.gumbel(key, (3,))
            return a + b
        """, "consumed twice"),
    ("""
        def init(key):
            w = my_init(key, 16)
            k2 = prng.fold_in(key, 1)
            return w, my_init(k2, 16)
        """, "split/fold_in parent"),
    ("""
        def roll(key, n):
            outs = []
            for i in range(n):
                outs.append(prng.uniform(key, (2,)))
            return outs
        """, "inside a loop"),
    ("""
        def pick(logits, rng):
            a, _ = _select_token(logits, rng, temperature=1.0, top_k=None, top_p=None)
            b, _ = _select_token(logits, rng, temperature=1.0, top_k=None, top_p=None)
            return a, b
        """, "consumed twice"),
], ids=["consumed-twice", "consume-then-derive", "loop", "sampling-helper-twice"])
def test_prng_reuse_fires(tmp_path, body, message):
    findings, _ = _scan(tmp_path, "from repro_torch import prng\n" + textwrap.dedent(body),
                        enabled="prng-reuse")
    assert len(findings) >= 1
    assert message in findings[0].message


def test_prng_clean_patterns_stay_silent(tmp_path):
    """split-reassign, per-iteration fold_in, exclusive return branches,
    keys passed through torch selectors, and a sampling helper that hands
    back the advanced key in a loop are all fine."""
    findings, _ = _scan(tmp_path, """
        import torch
        from repro_torch import prng

        def good_split(key):
            key, sub = prng.split(key)
            a = prng.uniform(sub, (3,))
            b = prng.uniform(key, (3,))
            return a + b

        def good_fold_loop(key, n):
            return [prng.uniform(prng.fold_in(key, i), (2,)) for i in range(n)]

        def good_branches(key, kind):
            if kind == "a":
                return init_a(key)
            if kind == "b":
                return init_b(key)
            raise ValueError(kind)

        def good_select(key, t):
            k2, sub = prng.split(key)
            tok = prng.categorical(sub, t)
            return tok, torch.where(t > 0, k2, key)

        def good_advance(logits, key, n):
            rng = key.to(torch.int64)
            out = []
            for _ in range(n):
                tok, rng = _select_token(logits, rng, temperature=1.0,
                                         top_k=None, top_p=None)
                out.append(tok)
            return out
        """, enabled="prng-reuse")
    assert findings == []


# ---------------------------------------------------------------------------
# recompile-hazard
# ---------------------------------------------------------------------------

def test_recompile_graph_in_loop_and_immediate(tmp_path):
    findings, _ = _scan(tmp_path, """
        import torch
        from repro_torch.serving.graphs import PackedGraphs

        def bench(xs, fn):
            for x in xs:
                g = torch.cuda.CUDAGraph()          # flagged: graph in loop
                with torch.cuda.graph(g):           # flagged: capture in loop
                    fn(x)
                graphs = PackedGraphs(fn, 8, "cuda") # flagged: PackedGraphs in loop
            return PackedGraphs(fn, 8, "cuda")(xs[0], 4, False)   # flagged: immediate
        """, enabled="recompile-hazard")
    msgs = sorted(f.message for f in findings)
    assert len(findings) == 4, msgs
    assert sum("inside a loop" in m for m in msgs) == 3
    assert any("invoked immediately" in m for m in msgs)


def test_recompile_static_arg_hazards(tmp_path):
    findings, _ = _scan(tmp_path, """
        def _paged_prefill_step(tokens, *, cfg, start=0):
            return tokens[start:]

        def admit(reqs, tokens):
            _paged_prefill_step(tokens, cfg=[1, 2, 3])            # unhashable static
            _paged_prefill_step(tokens, cfg=lambda: 3)            # fresh lambda static
            for r in reqs:
                start = r.hit_len
                _paged_prefill_step(tokens, cfg=(), start=start)  # loop-varying static
        """, enabled="recompile-hazard")
    msgs = sorted(f.message for f in findings)
    assert len(findings) == 3
    assert any("unhashable literal" in m for m in msgs)
    assert any("fresh lambda" in m for m in msgs)
    assert any("reassigned inside the enclosing loop" in m for m in msgs)


def test_recompile_stable_static_calls_stay_silent(tmp_path):
    findings, _ = _scan(tmp_path, """
        from repro_torch.kernels import _build
        from repro_torch.serving.graphs import PackedGraphs

        def chunk(tok, ticks, sampled):
            return tok * ticks

        def drive(tok, n):
            graphs = PackedGraphs(chunk, 8, "cuda")   # bound outside any loop
            for _ in range(n):
                tok = graphs(tok, 4, False)          # constant variant: one capture
                _build.library("bsr_matmul")         # one name: one load
            return tok
        """, enabled="recompile-hazard")
    assert findings == []


def test_recompile_naive_adaptive_loop_antipattern(tmp_path):
    """A serving loop that feeds an unbounded load signal straight into
    the ``ticks`` variant key captures one graph per distinct level."""
    findings, _ = _scan(tmp_path, """
        from repro_torch.serving.graphs import PackedGraphs

        def chunk(tok, ticks, sampled):
            return tok * ticks

        def serve(engine, tok):
            graphs = PackedGraphs(chunk, 8, "cuda")
            while engine.pending:
                ticks = engine.queue_depth        # unbounded load signal
                tok = graphs(tok, ticks, False)
            return tok
        """, enabled="recompile-hazard")
    assert len(findings) == 1
    assert "reassigned inside the enclosing loop" in findings[0].message


def test_recompile_library_loaded_under_a_changing_name(tmp_path):
    findings, _ = _scan(tmp_path, """
        import ctypes
        from repro_torch.kernels import _build

        def load_all(names, paths):
            for name in names:
                _build.library(name)
            for p in paths:
                ctypes.CDLL(str(p))
        """, enabled="recompile-hazard")
    assert len(findings) == 2
    assert all("one library load per distinct value" in f.message for f in findings)


def test_recompile_sweep_clean_over_adaptive_serving_path():
    """The port's serving package carries no recompile hazard but the
    baselined per-prefix-hit ``start`` of the admission prefill (one
    captured variant per ``(L, start)`` on the card, as the reference's
    jit compiles one program per start): the adaptive policy's frozen
    levels, not a loop-varying value, feed the graphs' ``ticks``."""
    serving = REPO_ROOT / "src" / "repro_torch" / "serving"
    index = lint.build_index(REPO_ROOT, [serving])
    findings, _ = lint.run_rules(index, all_rules(), enabled={"recompile-hazard"})
    stray = [f.format() for f in findings
             if not ("_paged_prefill_step" in f.message and "`start`" in f.message)]
    assert stray == []
    assert not [f for f in findings if "slo" in f.path or "`ticks`" in f.message]


# ---------------------------------------------------------------------------
# kernel-constraints
# ---------------------------------------------------------------------------

KERNEL_TREE = {
    "csrc/k.cu": """
        // a kernel with a plain C entry point
        extern "C" int k_launch(int dtype, const void* x, void* out, int n,
                                float scale, void* stream) {
          return 0;
        }
        """,
    "kernels/_build.py": """
        launch_counts = {"k": 0}

        def library(name):
            return None

        def check(name, err):
            pass
        """,
    "kernels/k.py": """
        import ctypes
        from . import _build

        _FNS = {}

        def _launcher(name, n_ptrs, n_ints):
            fn = getattr(_build.library(name), f"{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * n_ints
                           + [ctypes.c_float, ctypes.c_void_p])
            return fn

        def k_plain(x):
            return x * 2

        def k_cuda(x):
            out = x.new_empty(x.shape)
            err = _launcher("k", 2, 1)(0, x.data_ptr(), out.data_ptr(), x.numel(),
                                       1.0, None)
            _build.check("k", err)
            _build.launch_counts["k"] += 1
            return out
        """,
    "kernels/ops.py": """
        from .k import k_cuda, k_plain

        def k(x):
            return k_cuda(x) if x.is_cuda else k_plain(x)
        """,
}

# (file, old, new, message expected; None: stays clean)
KERNEL_MUTATIONS = [
    ("kernels/k.py", '_launcher("k", 2, 1)', '_launcher("k", 2, 2)',
     "passes 6 arguments but its argtypes declare 7"),
    ("kernels/k.py", "1.0, None)", "1.0, None, 3)",
     "passes 7 arguments but its argtypes declare 6"),
    ("csrc/k.cu", "int n,", "int n, int m,",
     "declare 6 parameters but its C signature has 7"),
    ("csrc/k.cu", "float scale", "int scale",
     "declare a float at position 4 where its C signature has a int"),
    ("csrc/k.cu", "k_launch", "k2_launch", "no `extern \"C\"` definition of `k_launch`"),
    ("kernels/k.py", "def k_plain", "def k_plainer", "has no `k_plain` twin"),
    ("kernels/ops.py", "k_cuda(x) if x.is_cuda else k_plain(x)", "k_cuda(x)",
     "does not dispatch to `k_plain`"),
    ("kernels/k.py", '    _build.check("k", err)\n', "",
     "is not followed by `_build.check(name, err)`"),
    ("kernels/k.py", '    _build.launch_counts["k"] += 1\n', "",
     "is not counted in `_build.launch_counts`"),
    ("kernels/k.py", '_build.launch_counts["k"] += 1', '_build.launch_counts["j"] += 1',
     "is counted under `j`, not its library `k`"),
    ("kernels/k.py", "fn.restype", "fn.restype", None),
]


@pytest.mark.parametrize("path,old,new,message", KERNEL_MUTATIONS,
                         ids=[m[3] or "clean" for m in KERNEL_MUTATIONS])
def test_kernel_constraints(tmp_path, path, old, new, message):
    for rel, src in KERNEL_TREE.items():
        text = textwrap.dedent(src)
        if rel == path:
            assert old in text
            text = text.replace(old, new)
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(text)
    index = lint.build_index(tmp_path, [tmp_path])
    findings, _ = lint.run_rules(index, all_rules(), enabled={"kernel-constraints"})
    msgs = [f.message for f in findings]
    if message is None:
        assert msgs == []
        assert launch_symbols(index) == ["k_launch"]
    else:
        # an argtypes change shows against both the call and the C side
        assert any(message in m for m in msgs) and len(msgs) <= 2, msgs


def test_kernel_constraints_see_every_launch_of_the_port():
    """The rule resolves the C symbol of each of the five kernels' launch
    sites in the port's tree (and finds nothing wrong with them)."""
    index = lint.build_index(REPO_ROOT, [REPO_ROOT / "src" / "repro_torch" / "kernels"])
    assert sorted(launch_symbols(index)) == [
        "bsr_matmul_launch", "bsr_planes_matmul_launch", "paged_decode_launch",
        "paged_prefill_launch", "structure_norms_launch"]
    findings, _ = lint.run_rules(index, all_rules(), enabled={"kernel-constraints"})
    assert findings == []


# ---------------------------------------------------------------------------
# framework: suppressions, toggles, baseline, keys, CLI
# ---------------------------------------------------------------------------

SUPPRESSED_SRC = """
    from repro_torch import prng

    def sample(key):
        a = prng.uniform(key, (3,))
        b = prng.gumbel(key, (3,))  # lint: ignore[prng-reuse]
        return a + b
    """


def test_inline_suppression_comment(tmp_path):
    findings, suppressed = _scan(tmp_path, SUPPRESSED_SRC)
    assert [f for f in findings if f.rule == "prng-reuse"] == []
    assert suppressed == 1


def test_inline_suppression_is_rule_scoped(tmp_path):
    findings, suppressed = _scan(tmp_path, SUPPRESSED_SRC.replace(
        "ignore[prng-reuse]", "ignore[host-sync]"))
    assert len([f for f in findings if f.rule == "prng-reuse"]) == 1
    assert suppressed == 0


def test_rule_toggles(tmp_path):
    src = """
        import torch
        from repro_torch import prng

        def bad(key, xs, fn):
            a = prng.uniform(key, (3,))
            b = prng.uniform(key, (3,))
            for x in xs:
                g = torch.cuda.CUDAGraph()
            return a + b
        """
    both, _ = _scan(tmp_path, src)
    only_prng, _ = _scan(tmp_path, src, enabled="prng-reuse")
    assert _rules_hit(both) == {"prng-reuse", "recompile-hazard"}
    assert _rules_hit(only_prng) == {"prng-reuse"}


def test_baseline_diff_and_stale(tmp_path):
    findings, _ = _scan(tmp_path, SUPPRESSED_SRC.replace(
        "  # lint: ignore[prng-reuse]", ""))
    base_path = tmp_path / "baseline.json"
    lint.write_baseline(base_path, findings)
    baseline = lint.load_baseline(base_path)
    diff = lint.diff_baseline(findings, baseline)
    assert diff.new == [] and len(diff.known) == 1 and diff.stale == []
    diff2 = lint.diff_baseline(findings + [lint.Finding(
        rule="prng-reuse", path="other.py", line=3, col=0,
        symbol="g", message="key `k` consumed twice without an interleaving split/fold_in")],
        baseline)
    assert len(diff2.new) == 1 and len(diff2.known) == 1
    diff3 = lint.diff_baseline([], baseline)
    assert len(diff3.stale) == 1


def test_finding_keys_are_line_number_free(tmp_path):
    src = SUPPRESSED_SRC.replace("  # lint: ignore[prng-reuse]", "")
    f1, _ = _scan(tmp_path, src)
    f2, _ = _scan(tmp_path, "import os\nimport sys\n\n" + textwrap.dedent(src))
    assert [f.key() for f in f1] == [f.key() for f in f2]
    assert f1[0].line != f2[0].line


def test_cli_exit_codes_baseline_and_rules(tmp_path, capsys):
    """0 clean against the baseline, 1 with a new finding under
    --fail-on-new, 2 for an unknown rule; --write-baseline keeps notes;
    --list-rules prints the four rules."""
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    mod = tmp_path / "src" / "repro_torch" / "m.py"
    mod.write_text(textwrap.dedent(SUPPRESSED_SRC.replace("  # lint: ignore[prng-reuse]", "")))
    base = tmp_path / "base.json"
    args = ["--root", str(tmp_path), "--baseline", str(base)]
    assert cli(args + ["--fail-on-new"]) == 1
    assert cli(args) == 0                       # reported, not failed
    assert cli(args + ["--write-baseline"]) == 0
    entries = json.loads(base.read_text())["entries"]
    (key,) = entries
    entries[key]["note"] = "kept on purpose"
    base.write_text(json.dumps({"entries": entries}))
    capsys.readouterr()
    assert cli(args + ["--fail-on-new", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert (report["findings"], report["new"], report["baselined"]) == (1, 0, 1)
    assert cli(args + ["--write-baseline"]) == 0
    assert json.loads(base.read_text())["entries"][key]["note"] == "kept on purpose"
    assert cli(args + ["--rules", "prng-reuse,nope"]) == 2
    capsys.readouterr()
    assert cli(["--list-rules"]) == 0
    assert capsys.readouterr().out.split() == [
        "host-sync", "kernel-constraints", "prng-reuse", "recompile-hazard"]
    mod.write_text("x = 1\n")                    # fixed: the entry is stale
    assert cli(args + ["--fail-on-new"]) == 0
    assert "STALE" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the sweep over the port's tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep():
    return lint.run_project(REPO_ROOT)


def test_port_sweep_is_clean_against_its_baseline(sweep):
    """The gate chip_smoke.py runs: the port lints clean against its own
    baseline (not the reference's), with no stale entries, and every
    baselined finding carries a real justification."""
    assert lint.DEFAULT_SCAN_PATHS == ("src/repro_torch", "chip_smoke.py")
    assert sweep.files_scanned > 90
    assert [f.format() for f in sweep.diff.new] == []
    assert sweep.diff.stale == []
    baseline = lint.load_baseline(REPO_ROOT / lint.BASELINE_NAME)
    assert lint.BASELINE_NAME != "analysis_baseline.json"
    assert len(baseline) == len(sweep.diff.known)
    for key, entry in baseline.items():
        assert entry.get("note") and "TODO" not in entry["note"], key


def test_rules_silent_on_the_port_are_named(sweep):
    """Each rule either has a baselined real finding in the port's tree
    or is named here as finding nothing there: the port's hot path has no
    undeclared host pull, no reused key and no kernel launch that drifts
    from its C signature (each rule's fixtures above show it fires)."""
    baseline = lint.load_baseline(REPO_ROOT / lint.BASELINE_NAME)
    baselined = {e["rule"] for e in baseline.values()}
    silent = set(rule_names()) - baselined
    assert baselined == {"recompile-hazard"}
    assert silent == {"host-sync", "kernel-constraints", "prng-reuse"}
    assert not silent & set(sweep.by_rule())


def test_hot_set_covers_the_serving_path(sweep):
    """The hot closure reaches the packed chunk, the kernels' wrappers and
    their plain versions, and not the analyzer or the launchers."""
    index = lint.build_index(REPO_ROOT, [REPO_ROOT / p for p in lint.DEFAULT_SCAN_PATHS])
    hot = {f"{m.path}::{fi.qualname}" for m in index.modules for fi in m.functions
           if index.is_hot(fi)}
    for name in ("src/repro_torch/serving/engine.py::_decode_chunk_packed",
                 "src/repro_torch/kernels/ops.py::paged_attention_decode",
                 "src/repro_torch/kernels/paged_attention.py::paged_attention_decode_plain",
                 "src/repro_torch/kernels/block_sparse_matmul.py::bsr_matmul_cuda"):
        assert name in hot
    assert not [h for h in hot if "/analysis/rules/" in h or "/analysis/lint.py" in h
                or "/launch/" in h]
    assert {"_decode_chunk", "_chunk_fn", "graphs"} <= set(index.jits_by_name)
    assert set(index.jits_by_name["_decode_chunk"].static_argnames) >= {"ticks", "sampled", "cfg"}
