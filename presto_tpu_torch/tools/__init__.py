"""Measurement scripts for the card, run as files (see each docstring)."""
