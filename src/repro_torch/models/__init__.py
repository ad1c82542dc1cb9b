"""Model code of the port (dense attention models on paged KV)."""
