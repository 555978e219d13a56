"""Host-side evaluation helpers (numpy): episode metrics and path
statistics."""
