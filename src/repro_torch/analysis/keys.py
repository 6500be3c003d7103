"""AST lint for the port's random draws (port of ``src/repro/analysis/keys.py``).

The port draws every random number from an explicit ``torch.Generator``
(the state's ``rng``, the data's generator, a population store's) or an
explicit ``numpy.random.Generator``, so that a run replays from its seeds
and a test can inject the reference's draws in their place. A draw from a
global stream -- PyTorch's default generator, or numpy's module-level
functions -- breaks both silently. This module is the static form of that
rule.

One rule (findings carry its name):

* ``global-random`` -- a call of ``torch.{rand, randn, randint, randperm,
  bernoulli, multinomial, normal, poisson}`` without ``generator=``; an
  in-place draw ``Tensor.{uniform_, normal_, bernoulli_, random_,
  exponential_, geometric_, log_normal_, cauchy_}`` without
  ``generator=`` (any receiver: the lint cannot tell a tensor's type, so a
  method of one of these names counts); or a ``numpy.random.*`` call of the
  module-level global stream. ``numpy.random.default_rng``, ``Generator``,
  ``SeedSequence`` and the bit generators build explicit streams and are
  fine, as is any call on a generator object.

The reference's ``key-reuse`` rule has no torch counterpart: a JAX key
yields the same numbers every time it is consumed, so consuming one twice
is a silent repeat, while a ``torch.Generator`` advances on every draw and
cannot repeat by reuse. Its ``host-random`` rule (numpy's global stream
inside traced code) becomes the numpy half of ``global-random``, here in
any scope: eager code has no trace to bake a draw into, but the global
stream still escapes the run's seeds.

False-positive escape hatch: append ``# rng-ok: <reason>`` to the flagged
line. The audit CLI requires *zero unsuppressed findings* over
``src/repro_torch``.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

SUPPRESS_MARK = "# rng-ok"

TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
                         "normal", "poisson"})
TENSOR_DRAWS = frozenset({"uniform_", "normal_", "bernoulli_", "random_", "exponential_",
                          "geometric_", "log_normal_", "cauchy_"})
NUMPY_EXPLICIT = frozenset({"default_rng", "Generator", "SeedSequence", "RandomState",
                            "BitGenerator", "PCG64", "PCG64DXSM", "MT19937", "Philox",
                            "SFC64"})


@dataclasses.dataclass(frozen=True)
class KeyFinding:
    path: str
    line: int
    rule: str  # "global-random" | "parse-error"
    message: str
    suppressed: bool = False

    def __str__(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


def _dotted(node: ast.AST) -> str | None:
    """`a.b.c` -> "a.b.c" for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Aliases(ast.NodeVisitor):
    """Import aliases for torch / numpy / numpy.random (any scope)."""

    def __init__(self):
        self.torch: set[str] = set()
        self.numpy: set[str] = set()
        self.np_random: set[str] = set()
        self.direct: dict[str, str] = {}   # local name -> torch draw
        self.np_direct: dict[str, str] = {}  # local name -> numpy.random fn

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            bound = a.asname or a.name.split(".")[0]
            if a.name == "torch":
                self.torch.add(bound)
            elif a.name == "numpy":
                self.numpy.add(bound)
            elif a.name == "numpy.random":
                (self.np_random if a.asname else self.numpy).add(bound)

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.module == "torch":
            for a in node.names:
                if a.name in TORCH_DRAWS:
                    self.direct[a.asname or a.name] = a.name
        elif node.module == "numpy":
            for a in node.names:
                if a.name == "random":
                    self.np_random.add(a.asname or "random")
        elif node.module == "numpy.random":
            for a in node.names:
                self.np_direct[a.asname or a.name] = a.name


class KeyLint:
    """Lint one python source file; collect findings."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.aliases = _Aliases()
        self.aliases.visit(self.tree)
        self.findings: list[KeyFinding] = []

    def _emit(self, line: int, message: str):
        text = self.lines[line - 1] if 0 < line <= len(self.lines) else ""
        self.findings.append(KeyFinding(self.path, line, "global-random", message,
                                        SUPPRESS_MARK in text))

    def _check(self, call: ast.Call):
        has_gen = any(k.arg == "generator" for k in call.keywords)
        al = self.aliases
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in al.direct and not has_gen:
                self._emit(call.lineno, f"torch.{al.direct[f.id]} without generator= draws "
                                        "from the global generator")
            elif f.id in al.np_direct and al.np_direct[f.id] not in NUMPY_EXPLICIT:
                self._emit(call.lineno, f"numpy.random.{al.np_direct[f.id]} draws from "
                                        "numpy's global stream")
            return
        chain = _dotted(f)
        parts = chain.split(".") if chain else []
        if len(parts) == 2 and parts[0] in al.torch and parts[1] in TORCH_DRAWS:
            if not has_gen:
                self._emit(call.lineno, f"torch.{parts[1]} without generator= draws from the "
                                        "global generator")
            return
        if ((len(parts) == 3 and parts[0] in al.numpy and parts[1] == "random")
                or (len(parts) == 2 and parts[0] in al.np_random)):
            fn = parts[-1]
            if fn not in NUMPY_EXPLICIT:
                self._emit(call.lineno, f"numpy.random.{fn} draws from numpy's global stream")
            return
        if isinstance(f, ast.Attribute) and f.attr in TENSOR_DRAWS and not has_gen:
            self._emit(call.lineno, f"Tensor.{f.attr} without generator= draws from the "
                                    "global generator")

    def run(self) -> list[KeyFinding]:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                self._check(node)
        self.findings.sort(key=lambda k: k.line)
        return self.findings


def lint_source(source: str, path: str = "<string>") -> list[KeyFinding]:
    return KeyLint(path, source).run()


def lint_file(path: Path | str) -> list[KeyFinding]:
    p = Path(path)
    try:
        return lint_source(p.read_text(), str(p))
    except SyntaxError as e:
        return [KeyFinding(str(p), e.lineno or 0, "parse-error", str(e))]


def lint_paths(roots: list[Path | str]) -> list[KeyFinding]:
    """Lint every ``.py`` under the given files/directories."""
    out: list[KeyFinding] = []
    for root in roots:
        root = Path(root)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            out.extend(lint_file(f))
    return out


def unsuppressed(findings: list[KeyFinding]) -> list[KeyFinding]:
    return [f for f in findings if not f.suppressed]
