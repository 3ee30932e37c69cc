"""Masked multi-head neighbourhood attention (forward)."""
