"""Logging and step timing for the port."""
