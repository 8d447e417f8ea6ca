"""Tuple layout and relation generation."""
