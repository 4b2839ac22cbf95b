"""Logs and pictures of a training run (``visualization``)."""
