"""Dispatch rule, execution context and exactness bounds (torch-free)."""
