"""Rays, poses and scene fixtures."""
