"""Serving: the paged-KV engine and its scheduler core."""
