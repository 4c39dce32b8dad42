"""Activation stores and synthetic data."""
