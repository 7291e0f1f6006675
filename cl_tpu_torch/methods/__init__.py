"""Continual-learning methods of the port (LwF so far)."""
