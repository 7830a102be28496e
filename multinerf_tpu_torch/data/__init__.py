"""Cameras, ray types and the datasets of the render path."""
