"""Index engines: the flat exact vector index."""
