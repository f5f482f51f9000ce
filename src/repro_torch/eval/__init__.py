"""Similarity / analogy / categorization scores (numpy). The package
exports the names ``repro.eval`` exports."""

from repro_torch.eval.benchmarks import (
    BenchmarkSuite,
    evaluate_all,
    evaluate_analogy,
    evaluate_categorization,
    evaluate_similarity,
    spearman,
)

__all__ = [
    "spearman",
    "evaluate_similarity",
    "evaluate_analogy",
    "evaluate_categorization",
    "evaluate_all",
    "BenchmarkSuite",
]
