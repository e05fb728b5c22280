"""Smoother families."""
