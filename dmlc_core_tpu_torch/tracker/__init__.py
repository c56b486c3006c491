"""Tracker helpers the device iterator needs (a copy, not an import)."""
