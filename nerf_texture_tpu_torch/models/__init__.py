"""Field models."""
