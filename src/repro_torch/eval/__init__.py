"""Accuracy evaluation across coding schemes."""
