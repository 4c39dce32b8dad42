"""Artifacts, logging and state carry-over."""
