"""Launchers.  Only the serving driver is ported so far."""
