"""Sparsity tables of the unstructured operators (single device)."""
