"""Launchers: the serving driver and the training driver."""
