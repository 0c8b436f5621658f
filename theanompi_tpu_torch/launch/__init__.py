"""Launchers: the training loop and the session API."""
