"""Launchers (``serve.py``, ``train.py``)."""
