"""Console client (reference: cli/main.py)."""
