"""Measurement scripts of the port that need the card (run on an H100)."""
