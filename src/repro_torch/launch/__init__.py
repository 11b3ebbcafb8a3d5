"""Launchers (``serve.py``)."""
