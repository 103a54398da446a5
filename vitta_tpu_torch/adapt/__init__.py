"""Adaptation engine and stream loops of the port."""
