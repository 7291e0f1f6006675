"""Continual-learning methods of the port: EWC, LwF and replay."""
