"""Mamba-1 selective scan (forward)."""
