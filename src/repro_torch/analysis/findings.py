"""Findings and the allowlist: the reporting substrate of
`repro_torch.analysis` (the JAX package's `analysis/findings.py`, copied).

Every check — the run-time invariant checks in
:mod:`repro_torch.analysis.checks` and the AST lint rules in
:mod:`repro_torch.analysis.astlint` — reports :class:`Finding`s: one rule
violation at one location (``file:line`` where the layer can resolve it,
the checked plan method otherwise), carrying a stable rule ID so the
output is grep-able and the allowlist can pin exceptions to rules.

The :class:`Allowlist` is the *audit trail* for known violations: each
entry names a rule, a location (path glob, optionally ``::symbol`` for the
enclosing function), and a mandatory one-line justification — entries
without a justification are a parse error, so nothing gets silenced
without a recorded reason.  The same file carries the ``[scaffold]``
section: the LM modules of the port (``models/``, the LLM config presets,
``kernels/flash_attention.py``) that the ``RP-LEGACY-SCAFFOLD`` rule
fences off from the graph-filter path, each with its audit note.
`src/repro_torch/analysis/lint_allowlist.txt` is the port's instance;
``python -m repro_torch.analysis --check`` is the entry point that
applies it.

File format (stdlib-parsed, comments with ``#``)::

    [scaffold]
    src/repro_torch/models/* -- LM forward; not imported by the graph path
    [allow]
    RP-FALLBACK-LOG src/repro_torch/kernels/ops.py::fused_cheb_sweep -- ...
"""
from __future__ import annotations

import dataclasses
import fnmatch
import os
from typing import Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location.

    path: repo-relative file for AST findings; for run-time findings the
    source file of the port's innermost frame at the offending op when
    there is one, else the checked-target label.  symbol: enclosing
    function (AST layer) or the checked plan method (run-time layer) —
    what allowlist entries pin to, so line drift does not invalidate
    them.
    """

    rule: str
    path: str
    message: str
    line: int = 0
    symbol: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def __str__(self) -> str:
        sym = f" ({self.symbol})" if self.symbol else ""
        return f"{self.location} [{self.rule}]{sym}: {self.message}"


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    """One allowlisted (rule, location) with its mandatory justification."""

    rule: str
    path_glob: str
    symbol: Optional[str]
    justification: str

    def matches(self, finding: Finding) -> bool:
        if self.rule != "*" and self.rule != finding.rule:
            return False
        path = finding.path.replace(os.sep, "/")
        if not (fnmatch.fnmatch(path, self.path_glob)
                or fnmatch.fnmatch(os.path.basename(path), self.path_glob)):
            return False
        if self.symbol and self.symbol != finding.symbol:
            return False
        return True


@dataclasses.dataclass(frozen=True)
class ScaffoldEntry:
    """One audited legacy-scaffold module (glob) with its justification."""

    path_glob: str
    justification: str


class AllowlistError(ValueError):
    """Malformed allowlist file (e.g. an entry without a justification)."""


@dataclasses.dataclass
class Allowlist:
    """Parsed allowlist: suppression entries + the scaffold audit."""

    entries: List[AllowEntry] = dataclasses.field(default_factory=list)
    scaffold: List[ScaffoldEntry] = dataclasses.field(default_factory=list)
    path: str = ""

    @classmethod
    def load(cls, path: str) -> "Allowlist":
        entries: List[AllowEntry] = []
        scaffold: List[ScaffoldEntry] = []
        section = "allow"
        with open(path, encoding="utf-8") as fh:
            for lineno, raw in enumerate(fh, 1):
                line = raw.split("#", 1)[0].strip() if not raw.lstrip() \
                    .startswith("#") else ""
                if raw.lstrip().startswith("#") or not line:
                    continue
                if line.startswith("[") and line.endswith("]"):
                    section = line[1:-1].strip().lower()
                    if section not in ("allow", "scaffold"):
                        raise AllowlistError(
                            f"{path}:{lineno}: unknown section [{section}]")
                    continue
                if " -- " not in line:
                    raise AllowlistError(
                        f"{path}:{lineno}: entry needs a ' -- justification'"
                        f" (got {line!r}) — every exception is audited")
                spec, justification = line.split(" -- ", 1)
                justification = justification.strip()
                if not justification:
                    raise AllowlistError(
                        f"{path}:{lineno}: empty justification")
                if section == "scaffold":
                    scaffold.append(ScaffoldEntry(spec.strip(), justification))
                    continue
                parts = spec.split(None, 1)
                if len(parts) != 2:
                    raise AllowlistError(
                        f"{path}:{lineno}: allow entry is 'RULE path[::symbol]"
                        f" -- justification' (got {line!r})")
                rule, loc = parts
                symbol = None
                if "::" in loc:
                    loc, symbol = loc.split("::", 1)
                entries.append(AllowEntry(rule.strip(), loc.strip(), symbol,
                                          justification))
        return cls(entries=entries, scaffold=scaffold, path=path)

    @property
    def scaffold_globs(self) -> Tuple[str, ...]:
        return tuple(e.path_glob for e in self.scaffold)

    def split(self, findings: Iterable[Finding]
              ) -> Tuple[List[Finding], List[Finding]]:
        """(kept, suppressed) — kept are the violations that still fail."""
        kept: List[Finding] = []
        suppressed: List[Finding] = []
        for f in findings:
            (suppressed if any(e.matches(f) for e in self.entries)
             else kept).append(f)
        return kept, suppressed

    def unused_entries(self, findings: Sequence[Finding]) -> List[AllowEntry]:
        """Allow entries that matched nothing — stale audit records that
        should be pruned (reported as warnings, not failures)."""
        return [e for e in self.entries
                if not any(e.matches(f) for f in findings)]
