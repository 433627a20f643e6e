"""Per-layer metric readers: metrics/<name>.py holds read(record)."""
