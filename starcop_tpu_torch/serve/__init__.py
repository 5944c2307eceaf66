"""Serving runtime: the threaded read | compute | write pipeline over granules."""
