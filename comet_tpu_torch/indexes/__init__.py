"""Index engines: the flat exact vector index and the IVF index."""
