"""Summation and host interop helpers."""
