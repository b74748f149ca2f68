"""Utilities of the port: timing on the card and the roofline model."""
