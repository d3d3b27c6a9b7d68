"""Samplers over the generator."""
