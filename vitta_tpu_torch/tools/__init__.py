"""Measurement scripts of the port, run on the card."""
