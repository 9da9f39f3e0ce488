"""Numerical guards of the train step."""
