"""Synthetic CTDG event streams."""
