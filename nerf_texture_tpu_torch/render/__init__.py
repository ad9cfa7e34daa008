"""Rendering orchestration."""
