"""Objective quality metrics of synthesised speech."""
