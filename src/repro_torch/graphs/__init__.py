"""Seeded synthetic stand-ins for the paper's evaluation graphs."""
