"""Coordinate sort."""
