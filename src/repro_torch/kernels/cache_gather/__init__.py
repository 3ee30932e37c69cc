"""Fused feature-cache probe and row gather."""
