"""Texture synthesis: patch export from a trained field, and quilting."""
