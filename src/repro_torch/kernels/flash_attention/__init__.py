"""Causal/non-causal GQA attention with an online softmax (forward)."""
