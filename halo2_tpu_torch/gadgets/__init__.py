"""Reusable circuit gadgets/chips — rebuild of halo2_gadgets (SURVEY.md §2.31-35)."""
