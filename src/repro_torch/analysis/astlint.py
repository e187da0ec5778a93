"""The port's AST lint rules over `src/repro_torch` and `chip_smoke.py`:
the JAX package's `analysis/astlint.py`, restated in PyTorch's idiom.

Stdlib-only static passes that encode decisions the port already made,
so they stop regressing silently:

* ``RP-DENSE-MAT`` — no dense materialization on library paths: an
  eigendecomposition (``eigh`` / ``eigvalsh``: the O(N^3) work the paper
  exists to avoid), a sparse layout made dense (``to_dense`` /
  ``todense``) or ``block_ell_to_dense``.  The reference paths may: the
  ``*_plain`` functions beside each kernel (:data:`REF_FUNCTION`) and
  the float64 oracle (:data:`REF_PATHS`).
* ``RP-ORDER-LOOP`` — a Python loop over Chebyshev orders (``for ... in
  range(.. K ..)``) only in the named per-order paths (``_per_order_*``,
  ``*_recurrence_loop``) and the plain versions.  PyTorch has no
  ``lax.scan``, so the per-order path is a Python loop by nature; every
  other place should send the recurrence to the sweep kernel.
* ``RP-HOST-SYNC`` — no host sync in library code: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``,
  ``Event.synchronize()``.  Host syncs belong to the smoke, the
  benchmarks and the tests, never inside plan methods where they stall
  the launch queue.
* ``RP-FALLBACK-LOG`` — an ``if`` branch that calls a fallback
  (``_per_order_*``, ``_fallback*``, ``*_recurrence_loop``,
  ``*_plain``) must also emit a ``logger.info`` / ``logger.warning`` in
  the same branch, as `kernels/ops.py::fused_cheb_sweep` does.
* ``RP-LEGACY-SCAFFOLD`` — the LM modules (the ``[scaffold]`` section of
  the allowlist: ``models/``, the LLM config presets,
  ``kernels/flash_attention.py``) are not imported from graph-path code.
  Scaffold modules may import each other freely.
* ``RP-NO-JAX`` — the port and its smoke import no ``jax``, ``jaxlib``
  or ``repro`` (the JAX package), scaffold modules included.

Findings carry file:line + the enclosing function as ``symbol``, so
allowlist entries pin to ``path::function`` and survive line drift.
`lint_tree` walks a source root; ``python -m repro_torch.analysis
--check`` applies `src/repro_torch/analysis/lint_allowlist.txt`.
"""
from __future__ import annotations

import ast
import fnmatch
import os
import re
from typing import Iterable, List, Optional, Sequence, Tuple

from .findings import Finding

#: Rule IDs of the AST layer.
AST_RULES = (
    "RP-DENSE-MAT",
    "RP-ORDER-LOOP",
    "RP-HOST-SYNC",
    "RP-FALLBACK-LOG",
    "RP-LEGACY-SCAFFOLD",
    "RP-NO-JAX",
)

#: Reference paths beyond the plain versions, as ``path::function``: the
#: float64 eigendecomposition oracle behind `exact_apply` and the error
#: measurements, never called by a plan method.
REF_PATHS = ("src/repro_torch/core/multiplier.py::_eig",)
#: Enclosing functions that are reference paths: the plain version
#: beside each kernel.
REF_FUNCTION = re.compile(r"_plain$")
#: Enclosing functions that are the per-order paths by name.
PER_ORDER_FUNCTION = re.compile(r"(^_per_order_|_recurrence_loop$)")

_DENSE_CALLS = {"eigh", "eigvalsh", "block_ell_to_dense", "to_dense",
                "todense"}
_HOST_SYNC_CALLS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_FALLBACK_NAME = re.compile(
    r"(^_per_order_|^_fallback|_recurrence_loop$|_plain$)")
_LOG_METHODS = {"info", "warning"}
_FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro"}


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _call_name(node: ast.Call) -> Tuple[str, Optional[str]]:
    """(terminal name, attribute base dotted-or-None) of a call target."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id, None
    if isinstance(f, ast.Attribute):
        base = f.value
        parts = []
        while isinstance(base, ast.Attribute):
            parts.append(base.attr)
            base = base.value
        if isinstance(base, ast.Name):
            parts.append(base.id)
        return f.attr, ".".join(reversed(parts)) or None
    return "", None


def _is_scaffold(relpath: str, scaffold_globs: Sequence[str]) -> bool:
    p = _norm(relpath)
    return any(fnmatch.fnmatch(p, g) for g in scaffold_globs)


def _resolve_import(module: Optional[str], level: int, alias: str,
                    file_relpath: str, src_root: str) -> Optional[str]:
    """Repo-relative path a (possibly relative) import resolves to.

    Handles ``import a.b``, ``from a.b import c`` and relative forms
    (``from . import ops``, ``from .flash_attention import f``); returns
    the module file (or package ``__init__.py``) path relative to the
    repo root, or None when the target is not a file under `src_root`
    (external package, or a symbol rather than a submodule).
    """
    if level:
        base = os.path.dirname(file_relpath)
        for _ in range(level - 1):
            base = os.path.dirname(base)
        parts = [base] + (module.split(".") if module else [])
    else:
        parts = [src_root] + module.split(".") if module else []
    for candidate in ([*parts, alias] if alias else [], parts):
        if not candidate:
            continue
        stem = os.path.join(*candidate)
        for path in (stem + ".py", os.path.join(stem, "__init__.py")):
            if os.path.isfile(path):
                return _norm(path)
    return None


class _Visitor(ast.NodeVisitor):
    """Single-pass rule visitor with an enclosing-function stack."""

    def __init__(self, relpath: str, src_root: str,
                 scaffold_globs: Sequence[str]):
        self.relpath = _norm(relpath)
        self.src_root = src_root
        self.scaffold_globs = tuple(scaffold_globs)
        self.is_scaffold = _is_scaffold(self.relpath, scaffold_globs)
        self.findings: List[Finding] = []
        self._funcs: List[str] = []

    # -- bookkeeping --------------------------------------------------------
    @property
    def symbol(self) -> str:
        return self._funcs[-1] if self._funcs else ""

    def _in(self, pattern: re.Pattern) -> bool:
        return any(pattern.search(f) for f in self._funcs)

    @property
    def is_ref(self) -> bool:
        return self._in(REF_FUNCTION) or any(
            self.relpath == path and fn in self._funcs
            for path, _, fn in (r.partition("::") for r in REF_PATHS))

    def _add(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.relpath, line=getattr(node, "lineno", 0),
            symbol=self.symbol, message=message))

    def visit_FunctionDef(self, node):
        self._funcs.append(node.name)
        self.generic_visit(node)
        self._funcs.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- RP-NO-JAX / RP-LEGACY-SCAFFOLD -------------------------------------
    def _check_root(self, node, module: Optional[str], level: int) -> None:
        if level == 0 and module \
                and module.split(".")[0] in _FORBIDDEN_ROOTS:
            self._add("RP-NO-JAX", node,
                      f"imports `{module}` — the port runs on PyTorch alone "
                      "and keeps its own copy of what it needs from the JAX "
                      "package")

    def _check_import(self, node, module: Optional[str], level: int,
                      alias: str) -> None:
        if self.is_scaffold:
            return
        target = _resolve_import(module, level, alias, self.relpath,
                                 self.src_root)
        if target and _is_scaffold(target, self.scaffold_globs):
            self._add("RP-LEGACY-SCAFFOLD", node,
                      f"imports LM scaffold `{target}` from graph-path "
                      "code — the scaffold modules are fenced off the "
                      "graph-filter path")

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self._check_root(node, a.name, 0)
            self._check_import(node, a.name, 0, "")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        self._check_root(node, node.module, node.level)
        for a in node.names:
            self._check_import(node, node.module, node.level, a.name)
        self.generic_visit(node)

    # -- RP-DENSE-MAT / RP-HOST-SYNC ---------------------------------------
    def visit_Call(self, node: ast.Call):
        name, _base = _call_name(node)
        method = isinstance(node.func, ast.Attribute)
        if name in _DENSE_CALLS and not self.is_ref \
                and (method or name not in ("to_dense", "todense")):
            self._add("RP-DENSE-MAT", node,
                      f"dense materialization `{name}(...)` outside the "
                      "reference paths — O(N^2) memory or O(N^3) work "
                      "defeats the distributed Chebyshev path")
        if name in _HOST_SYNC_CALLS and method:
            self._add("RP-HOST-SYNC", node,
                      f"host sync `.{name}()` in library code — stalls "
                      "the launch queue; belongs in the smoke, benchmarks "
                      "and tests only")
        self.generic_visit(node)

    # -- RP-ORDER-LOOP ------------------------------------------------------
    def visit_For(self, node: ast.For):
        if not (self.is_ref or self._in(PER_ORDER_FUNCTION)) \
                and isinstance(node.iter, ast.Call):
            name, _ = _call_name(node.iter)
            if name == "range" and any(
                    isinstance(n, ast.Name) and n.id == "K"
                    for a in node.iter.args for n in ast.walk(a)):
                self._add("RP-ORDER-LOOP", node,
                          "Python loop over Chebyshev orders (range over "
                          "K) outside the per-order paths and the plain "
                          "versions — send the recurrence to the sweep "
                          "kernel, or name the path _per_order_*")
        self.generic_visit(node)

    # -- RP-FALLBACK-LOG ----------------------------------------------------
    @staticmethod
    def _suite_fallback_calls(stmts: Iterable[ast.stmt]) -> List[ast.Call]:
        calls = []
        for stmt in stmts:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call) \
                        and _FALLBACK_NAME.search(_call_name(n)[0]):
                    calls.append(n)
        return calls

    @staticmethod
    def _has_log(stmts: Iterable[ast.stmt]) -> bool:
        for stmt in stmts:
            for n in ast.walk(stmt):
                if isinstance(n, ast.Call):
                    name, base = _call_name(n)
                    if name in _LOG_METHODS and base \
                            and base.split(".")[-1] in ("logger", "logging"):
                        return True
        return False

    def visit_If(self, node: ast.If):
        if not self.is_ref:
            for suite in (node.body, node.orelse):
                # an `elif` arm is a nested If in orelse; it gets its own
                # visit, so skip the wrapper suite to avoid double counts
                if len(suite) == 1 and isinstance(suite[0], ast.If):
                    continue
                calls = self._suite_fallback_calls(suite)
                if calls and not self._has_log(suite):
                    name, _ = _call_name(calls[0])
                    self._add("RP-FALLBACK-LOG", calls[0],
                              f"dispatch branch takes fallback `{name}` "
                              "without a logger.info/logger.warning in "
                              "the branch — slow paths must announce "
                              "themselves")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def lint_source(source: str, relpath: str, src_root: str = "src",
                scaffold_globs: Sequence[str] = ()) -> List[Finding]:
    """Lint one module's source text (fixture-friendly entry point).

    Scaffold modules (matching `scaffold_globs`) are held to
    ``RP-NO-JAX`` alone: the rule that concerns them otherwise is
    ``RP-LEGACY-SCAFFOLD`` *in their importers*, not their own internals.
    """
    tree = ast.parse(source, filename=relpath)
    visitor = _Visitor(relpath, src_root, scaffold_globs)
    visitor.visit(tree)
    if visitor.is_scaffold:
        return [f for f in visitor.findings if f.rule == "RP-NO-JAX"]
    return visitor.findings


def lint_file(path: str, src_root: str = "src",
              scaffold_globs: Sequence[str] = ()) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), _norm(path), src_root, scaffold_globs)


def lint_tree(root: str = "src/repro_torch", src_root: str = "src",
              scaffold_globs: Sequence[str] = (),
              extra_files: Sequence[str] = ()) -> List[Finding]:
    """Lint every ``.py`` under `root` and each of `extra_files` (the
    smoke), sorted for stable output."""
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                findings += lint_file(os.path.join(dirpath, fname),
                                      src_root, scaffold_globs)
    for path in extra_files:
        if os.path.isfile(path):
            findings += lint_file(path, src_root, scaffold_globs)
    return findings
