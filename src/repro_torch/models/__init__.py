"""Temporal GNN models (forward path)."""
