"""Repo-specific AST lint for reproducibility hazards, in torch spellings.

The counterpart of ``repro.analysis.lint_rules``, over ``src/repro_torch``.
Four rules encode the classes of bug the project has hit or designed
against:

* **RL001 arithmetic-seed** — a seed built by arithmetic and fed to a seed
  sink: ``torch.manual_seed(seed + w)``, ``Generator().manual_seed(seed *
  31 + i)``, ``np.random.SeedSequence(seed + w)``, ``default_rng(seed +
  w)``, ``prng.PRNGKey(seed + w)``. Arithmetic seeds collide across (worker,
  epoch) lattices; the convention is ``prng.fold_in`` / a tuple-fed
  ``np.random.SeedSequence`` (see ``core/driver._epoch_rng``).
* **RL002 searchsorted-side** — ``torch.searchsorted`` without an explicit
  ``right=`` or ``side=``, ``np.searchsorted`` without ``side=``. The side
  decides whether a u exactly on a CDF boundary lands in the open or
  closed bucket. Inside ``data/`` it must be the right side (the
  inverse-CDF convention of ``pairs.cdf_draw``).
* **RL003 unseeded-randomness** — inside ``core/``, ``kernels/`` and
  ``elastic/``: ``torch.rand*``/``randint``/``randn``/``randperm``/
  ``bernoulli``/``multinomial``/``normal`` and the in-place ``Tensor``
  samplers (``uniform_``, ``normal_``, ...) without ``generator=``; the
  legacy global-state ``np.random.*``; stdlib ``random.*``; an argless
  ``default_rng()``; or wall-clock time fed to a seed sink.
* **RL004 collective-in-train-path** — any ``torch.distributed``
  collective in ``kernels/``, ``data/``, ``core/engine.py``,
  ``core/sgns.py`` or ``elastic/``. The paper's zero-synchronization claim
  lives or dies here; ``core/async_trainer.py`` (the synchronous
  baselines) and ``sharding/merge.py`` (the merge's one ``all_gather``)
  are outside the scope, as in the reference.

Suppression: end the offending line with ``# repro-lint:
ignore[RL002]`` (comma-separate several rules) plus a justification —
the pragma is a reviewed exception, not an off switch.

Standalone: ``python -m repro_torch.analysis.lint_rules [root ...]``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path

PRAGMA_RE = re.compile(r"#\s*repro-lint:\s*ignore\[([A-Z0-9,\s]+)\]")

# Seed sinks: calls whose argument IS a seed.
_SEED_SINKS = {"manual_seed", "PRNGKey", "SeedSequence", "default_rng", "fold_in"}
# Legacy global-state numpy RNG entry points (np.random.<name>(...)).
_NP_LEGACY = {
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "seed", "choice", "shuffle", "permutation", "uniform",
    "normal", "standard_normal", "binomial", "poisson", "exponential",
}
# torch samplers that take a generator= (torch.<name>(...)).
_TORCH_SAMPLERS = {"bernoulli", "multinomial", "normal", "poisson"}
# In-place Tensor samplers (x.<name>(...)).
_TENSOR_SAMPLERS = {"uniform_", "normal_", "random_", "bernoulli_",
                    "exponential_", "geometric_", "cauchy_", "log_normal_"}
_WALLCLOCK = {"time", "time_ns", "monotonic", "monotonic_ns",
              "perf_counter", "perf_counter_ns"}
_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "broadcast_object_list", "reduce", "gather", "scatter",
    "barrier", "send", "recv", "isend", "irecv", "batch_isend_irecv",
    "all_reduce_coalesced", "all_gather_coalesced",
}

_RL003_SCOPE = ("core/", "kernels/", "elastic/")
_RL004_SCOPE = ("kernels/", "data/", "core/engine.py", "core/sgns.py", "elastic/")


@dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _call_name(node: ast.AST) -> str:
    """Rightmost identifier of a call target: ``a.b.c(...)`` → ``c``."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name: ``torch.distributed.all_reduce`` →
    itself; a call in the chain (``Generator().manual_seed``) ends it."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _has_name_operand(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Name) for n in ast.walk(node))


def _in_scope(rel: str, scopes: tuple[str, ...]) -> bool:
    return any(rel == s or rel.startswith(s) for s in scopes)


def _distributed_names(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(module aliases of ``torch.distributed``, collective names imported
    from it) in one file."""
    modules, funcs = {"torch.distributed"}, set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    modules.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module == "torch":
                modules.update(a.asname or a.name for a in node.names
                               if a.name == "distributed")
            elif node.module == "torch.distributed":
                funcs.update(a.asname or a.name for a in node.names
                             if a.name in _COLLECTIVES)
    return modules, funcs


def _kw(node: ast.Call, name: str):
    return next((kw for kw in node.keywords if kw.arg == name), None)


def _check_tree(tree: ast.AST, rel: str) -> list[LintFinding]:
    found: list[LintFinding] = []

    def add(rule: str, node: ast.AST, msg: str) -> None:
        found.append(LintFinding(rule, rel, node.lineno, msg))

    in_core = _in_scope(rel, _RL003_SCOPE)
    in_train_path = _in_scope(rel, _RL004_SCOPE)
    dist_modules, dist_funcs = _distributed_names(tree)

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _call_name(node.func)
        dotted = _dotted(node.func)

        # RL001: arithmetic seed construction fed to a seed sink.
        if fname in _SEED_SINKS:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.BinOp) and _has_name_operand(arg):
                    add("RL001", arg,
                        f"arithmetic seed passed to {fname}() — derive "
                        f"streams with prng.fold_in or a tuple-fed "
                        f"np.random.SeedSequence instead")
            # RL003 (seed-sink flavour): wall-clock seeding.
            if in_core:
                for sub in ast.walk(node):
                    if (isinstance(sub, ast.Call) and sub is not node
                            and _dotted(sub.func).startswith("time.")
                            and _call_name(sub.func) in _WALLCLOCK):
                        add("RL003", sub,
                            f"wall-clock {_dotted(sub.func)}() used as "
                            f"a seed for {fname}() — runs become "
                            f"unreplayable")

        # RL002: searchsorted side.
        if fname == "searchsorted":
            side, right = _kw(node, "side"), _kw(node, "right")
            if side is None and right is None:
                add("RL002", node,
                    "searchsorted without explicit side=/right= — boundary "
                    "semantics of CDF inversion must be spelled out")
            elif rel.startswith("data/"):
                wrong = ((side is not None and isinstance(side.value, ast.Constant)
                          and side.value.value != "right")
                         or (right is not None and isinstance(right.value, ast.Constant)
                             and right.value.value is not True))
                if wrong:
                    add("RL002", node,
                        "searchsorted on the left side in data/ — inverse-CDF "
                        "sampling requires the right side")

        if in_core:
            # RL003: torch samplers without an explicit generator.
            torch_sampler = (dotted.startswith("torch.") and dotted.count(".") == 1
                             and (fname.startswith("rand") or fname in _TORCH_SAMPLERS))
            if (torch_sampler or fname in _TENSOR_SAMPLERS) \
                    and _kw(node, "generator") is None:
                add("RL003", node,
                    f"{dotted or fname}() without generator= draws from the "
                    f"global torch RNG — pass a seeded torch.Generator")
            # RL003: legacy global-state numpy RNG.
            if (dotted.startswith(("np.random.", "numpy.random."))
                    and fname in _NP_LEGACY):
                add("RL003", node,
                    f"legacy global-state RNG {dotted}() — use an "
                    f"explicit np.random.Generator")
            # RL003: stdlib random module.
            if dotted.startswith("random.") and dotted.count(".") == 1:
                add("RL003", node,
                    f"stdlib {dotted}() draws from hidden global "
                    f"state — use an explicit seeded Generator")
            # RL003: unseeded default_rng().
            if (fname == "default_rng" and not node.args
                    and not node.keywords):
                add("RL003", node,
                    "default_rng() without a seed — entropy-seeded, "
                    "unreplayable")

        # RL004: torch.distributed collectives in the zero-collective path.
        if in_train_path:
            owner = dotted.rsplit(".", 1)[0] if "." in dotted else ""
            if ((owner in dist_modules and fname in _COLLECTIVES)
                    or (not owner and fname in dist_funcs)):
                add("RL004", node,
                    f"collective {dotted or fname}() in the "
                    f"zero-collective train path — synchronization "
                    f"belongs to the baselines in core/async_trainer.py "
                    f"and the merge in sharding/merge.py only")
    return found


def _suppressed(finding: LintFinding, lines: list[str]) -> bool:
    if not (1 <= finding.line <= len(lines)):
        return False
    m = PRAGMA_RE.search(lines[finding.line - 1])
    if not m:
        return False
    rules = {r.strip() for r in m.group(1).split(",")}
    return finding.rule in rules


def lint_file(path: Path, root: Path) -> list[LintFinding]:
    rel = path.relative_to(root).as_posix()
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [LintFinding("RL000", rel, e.lineno or 0,
                            f"syntax error: {e.msg}")]
    lines = src.splitlines()
    return [f for f in _check_tree(tree, rel) if not _suppressed(f, lines)]


def run_lint(root) -> list[LintFinding]:
    """Lint every ``*.py`` under ``root`` (a ``src/repro_torch``-like tree:
    rule path-scoping is relative to it). Returns surviving findings."""
    root = Path(root)
    found: list[LintFinding] = []
    for path in sorted(root.rglob("*.py")):
        found.extend(lint_file(path, root))
    return found


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=["src/repro_torch"],
                    help="package roots to lint (default: src/repro_torch)")
    args = ap.parse_args(argv)
    findings: list[LintFinding] = []
    for root in args.roots:
        findings.extend(run_lint(root))
    for f in findings:
        print(f"lint: {f}")
    n = len(findings)
    print(f"lint: {n} finding{'s' if n != 1 else ''} in "
          f"{', '.join(args.roots)}" + (": OK" if not n else ""))
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
