"""Paged temporal neighbour sampling (recent and uniform policies)."""
