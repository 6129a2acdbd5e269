"""Scenario configurations."""
