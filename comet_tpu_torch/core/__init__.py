"""Core data model: nodes, results, aggregation, limiting, filtering."""
