"""The docs layer of the port's lint: the JAX package's `tools/check_docs.py`
and its tracked-bytecode guard (`tools/lint_repro.py`), over the port.

Stdlib-only static checks, each reported as :class:`Finding`s under its
own rule ID so that one allowlist and one exit code cover every layer:

* ``DOC-LINK`` — every relative markdown link in `README.md` resolves
  to a file (anchors stripped; http(s), mailto and in-page links and
  links inside fenced code blocks are ignored).
* ``DOC-BACKEND`` — every backend registered under
  `src/repro_torch/dist/backends/` (the ``@register_backend("name")``
  decorators, found by AST, so a docstring example does not count) is
  named in the README's ``## PyTorch / H100 port`` section, the port's
  user-facing reference (`API.md` and `docs/` describe the JAX package).
* ``DOC-SOLVE-METHOD`` — every entry of the ``METHODS`` literal of
  `src/repro_torch/dist/solvers.py` (found by AST) is named there too.
* ``RP-TRACKED-BYTECODE`` — git tracks no ``__pycache__/`` directory and
  no ``.pyc`` / ``.pyo`` / ``.pyd`` file (`git ls-files`).

A name counts as named when it stands on its own in the section: not as
part of a longer identifier (``halo`` inside ``cuda_halo`` does not
count).  Every function takes the repository root, so the checks run on
any tree (the tests plant one violation per rule in a temporary one).
"""
from __future__ import annotations

import ast
import os
import re
import subprocess
from typing import List, Set, Tuple

from .findings import Finding

#: Rule IDs of the docs layer.
DOCS_RULES = (
    "DOC-LINK",
    "DOC-BACKEND",
    "DOC-SOLVE-METHOD",
    "RP-TRACKED-BYTECODE",
)

#: The README heading of the port's section.
PORT_SECTION = "## PyTorch / H100 port"
BACKENDS_DIR = os.path.join("src", "repro_torch", "dist", "backends")
SOLVERS = os.path.join("src", "repro_torch", "dist", "solvers.py")

#: markdown inline links [text](target); images share the syntax.
_LINK_RE = re.compile(r"\[[^\]]*\]\(([^)\s]+)(?:\s+\"[^\"]*\")?\)")
_FENCE_RE = re.compile(r"```.*?```", re.S)
_BYTECODE_SUFFIXES = (".pyc", ".pyo", ".pyd")


def _read(path: str) -> str:
    with open(path, encoding="utf-8") as f:
        return f.read()


def broken_links(repo: str) -> List[Tuple[str, str, str]]:
    """[(file, raw target, resolved path)] of README.md's relative links
    that resolve to nothing."""
    path = os.path.join(repo, "README.md")
    if not os.path.isfile(path):
        return []
    broken = []
    for target in _LINK_RE.findall(_FENCE_RE.sub("", _read(path))):
        if re.match(r"^(https?:|mailto:|#)", target):
            continue
        rel = target.split("#", 1)[0]
        resolved = os.path.normpath(os.path.join(repo, rel))
        if not os.path.exists(resolved):
            broken.append(("README.md", target,
                           os.path.relpath(resolved, repo)))
    return broken


def registered_backends(repo: str) -> Set[str]:
    """The names of the ``@register_backend("...")`` decorators on
    functions under `src/repro_torch/dist/backends/`."""
    names = set()
    root = os.path.join(repo, BACKENDS_DIR)
    for fname in sorted(os.listdir(root)):
        if not fname.endswith(".py"):
            continue
        tree = ast.parse(_read(os.path.join(root, fname)), filename=fname)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for deco in node.decorator_list:
                if (isinstance(deco, ast.Call)
                        and getattr(deco.func, "id",
                                    getattr(deco.func, "attr", None))
                        == "register_backend"
                        and deco.args
                        and isinstance(deco.args[0], ast.Constant)
                        and isinstance(deco.args[0].value, str)):
                    names.add(deco.args[0].value)
    return names


def solve_methods(repo: str) -> Set[str]:
    """The ``METHODS`` tuple literal of `src/repro_torch/dist/solvers.py`."""
    tree = ast.parse(_read(os.path.join(repo, SOLVERS)),
                     filename="solvers.py")
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "METHODS"
                        for t in node.targets)):
            return set(ast.literal_eval(node.value))
    raise ValueError(f"no METHODS literal in {SOLVERS}")


def port_section(repo: str) -> str:
    """The README's port section, from its heading to the next ``## ``
    heading ('' when the README or the section is missing)."""
    path = os.path.join(repo, "README.md")
    if not os.path.isfile(path):
        return ""
    text = _read(path)
    start = text.find(PORT_SECTION + "\n")
    if start < 0:
        return ""
    end = text.find("\n## ", start + len(PORT_SECTION))
    return text[start:] if end < 0 else text[start:end]


def _unnamed(names: Set[str], text: str) -> List[str]:
    return sorted(n for n in names
                  if not re.search(rf"(?<![\w-]){re.escape(n)}(?![\w-])",
                                   text))


def undocumented_backends(repo: str) -> List[str]:
    """Registered backends the README's port section does not name."""
    return _unnamed(registered_backends(repo), port_section(repo))


def undocumented_solve_methods(repo: str) -> List[str]:
    """`plan.solve` methods the README's port section does not name."""
    return _unnamed(solve_methods(repo), port_section(repo))


def tracked_bytecode(repo: str) -> List[str]:
    """Tracked bytecode paths (none outside a git work tree)."""
    try:
        tracked = subprocess.run(
            ["git", "ls-files"], cwd=repo, capture_output=True, text=True,
            check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return []
    return [p for p in tracked
            if "__pycache__/" in p or p.endswith(_BYTECODE_SUFFIXES)]


def docs_findings(repo: str) -> List[Finding]:
    """Every rule of the docs layer over the tree at `repo`."""
    out = [Finding(rule="DOC-LINK", path=path,
                   message=f"broken link ({target}) -> {resolved}")
           for path, target, resolved in broken_links(repo)]
    out += [Finding(rule="DOC-BACKEND", path="README.md",
                    message=f"backend {name!r} is registered but not named "
                            f"in the {PORT_SECTION!r} section")
            for name in undocumented_backends(repo)]
    out += [Finding(rule="DOC-SOLVE-METHOD", path="README.md",
                    message=f"plan.solve method {name!r} is not named in "
                            f"the {PORT_SECTION!r} section")
            for name in undocumented_solve_methods(repo)]
    out += [Finding(rule="RP-TRACKED-BYTECODE", path=path,
                    message="Python bytecode is tracked by git: git rm it "
                            "(__pycache__/ and *.pyc are git-ignored)")
            for path in tracked_bytecode(repo)]
    return out
