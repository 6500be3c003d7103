"""Launchers of the port (serving so far)."""
