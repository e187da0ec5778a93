"""The docs layer of the port's lint (`repro_torch.analysis.docs`): the
counterparts of tests/test_docs.py over the README's port section, the
lint's ``--layers ast,docs`` on the repository, and one planted violation
of each rule in a temporary tree, found under its own rule."""
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro_torch import analysis as A
from repro_torch.analysis import docs as D

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


def test_no_broken_links_in_readme():
    assert D.broken_links(ROOT) == []


def test_every_registered_backend_named_in_port_section():
    assert D.port_section(ROOT).startswith(D.PORT_SECTION)
    assert D.undocumented_backends(ROOT) == []


def test_static_backend_scan_matches_live_registry():
    """The AST scan agrees with what the registry holds at import."""
    from repro_torch.dist import available_backends

    assert D.registered_backends(ROOT) == set(available_backends())


def test_every_solve_method_named_in_port_section():
    assert D.undocumented_solve_methods(ROOT) == []


def test_static_solve_method_scan_matches_live_vocabulary():
    from repro_torch.dist.solvers import METHODS

    assert D.solve_methods(ROOT) == set(METHODS)


def test_lint_cli_ast_and_docs_layers_clean():
    """``python -m repro_torch.analysis --check --layers ast,docs`` exits 0
    on the repository, with no stale allowlist entry."""
    assert set(D.DOCS_RULES) <= set(A.ALL_RULES)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check",
         "--layers", "ast,docs"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stdout, proc.stdout + proc.stderr
    assert "layers=ast,docs" in proc.stdout
    assert "stale" not in proc.stderr, proc.stderr


# ---------------------------------------------------------------------------
# One planted violation per rule, in a temporary tree
# ---------------------------------------------------------------------------
README = textwrap.dedent("""\
    # A repo

    See [the notes](NOTES.md) and [the web](https://example.org).

    ## PyTorch / H100 port

    Backends: `dense` and `cuda`.  Solves: chebyshev and jacobi.  A
    plan's `info["halo_width"]` and `cheb_jacobi_table` name no backend
    and no method.

    ```bash
    [inside a fence](missing_but_fenced.md)
    ```

    ## Layout

    `halo` and arma are named here, outside the port section.
    """)

BACKEND = textwrap.dedent('''\
    """`@register_backend("in-a-docstring")` does not count."""
    from . import register_backend


    @register_backend({name!r})
    def build(op):
        return op
    ''')


def _tree(tmp_path, *, backends=("dense", "cuda"),
          methods=("chebyshev", "jacobi"), notes=True, bytecode=False):
    """A clean tree (README, backends, solvers.py, a git index); each
    keyword plants one violation."""
    root = tmp_path / "repo"
    bdir = root / D.BACKENDS_DIR
    bdir.mkdir(parents=True)
    (root / "README.md").write_text(README)
    if notes:
        (root / "NOTES.md").write_text("notes\n")
    for name in backends:
        (bdir / f"{name.replace('-', '_')}.py").write_text(
            BACKEND.format(name=name))
    (root / D.SOLVERS).write_text(f"METHODS = {tuple(methods)!r}\n")
    if shutil.which("git"):
        subprocess.run(["git", "init", "-q"], cwd=root, check=True)
        if bytecode:
            pyc = root / "src" / "__pycache__" / "m.cpython-312.pyc"
            pyc.parent.mkdir(parents=True)
            pyc.write_bytes(b"\0")
        subprocess.run(["git", "add", "-A", "-f"], cwd=root, check=True)
    return str(root)


def test_clean_tree_has_no_findings(tmp_path):
    root = _tree(tmp_path)
    assert D.registered_backends(root) == {"dense", "cuda"}
    assert D.docs_findings(root) == []


PLANTS = {
    "DOC-LINK": (dict(notes=False), "NOTES.md"),
    "DOC-BACKEND": (dict(backends=("dense", "cuda", "halo")), "'halo'"),
    "DOC-SOLVE-METHOD": (dict(methods=("chebyshev", "jacobi", "arma")),
                         "'arma'"),
    "RP-TRACKED-BYTECODE": (dict(bytecode=True), "__pycache__/"),
}


@pytest.mark.parametrize("rule", sorted(PLANTS))
def test_planted_violation_found_under_its_rule(tmp_path, rule):
    """A tree clean but for one planted violation gives exactly one
    finding, under that violation's rule (a name outside the port
    section, or inside a longer identifier, does not document it)."""
    if rule == "RP-TRACKED-BYTECODE" and not shutil.which("git"):
        pytest.fail("the bytecode rule reads `git ls-files`: git is needed")
    kwargs, needle = PLANTS[rule]
    findings = D.docs_findings(_tree(tmp_path, **kwargs))
    assert [f.rule for f in findings] == [rule], [str(f) for f in findings]
    assert needle in findings[0].path + findings[0].message
