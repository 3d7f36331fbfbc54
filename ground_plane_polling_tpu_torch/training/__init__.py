"""Evaluation sweep (training itself is ROADMAP A14)."""
