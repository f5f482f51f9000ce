"""Similarity / analogy / categorization scores (numpy)."""
