"""Serving engines over a frozen pipeline."""
