"""Launchers of the language models (serving)."""
