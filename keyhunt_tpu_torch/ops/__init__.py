"""Batched field, curve and match operations on (8, B) limb tensors."""
