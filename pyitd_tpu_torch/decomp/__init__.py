"""Decompositions built on the ops."""
