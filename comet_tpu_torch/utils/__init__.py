"""Utilities: memory accounting."""
