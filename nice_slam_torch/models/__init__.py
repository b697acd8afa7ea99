"""Decoder models: parameter trees + apply functions."""
