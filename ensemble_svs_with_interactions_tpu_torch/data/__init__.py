"""Multitrack data helpers used at inference."""
