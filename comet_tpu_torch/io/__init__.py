"""Binary serialization helpers."""
