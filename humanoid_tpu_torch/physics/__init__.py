"""Batched rigid-body physics on torch tensors (flat ground, PGS contact)."""
