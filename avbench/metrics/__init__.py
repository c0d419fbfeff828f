"""Per-metric readers: metrics/<name>.py holds `read(run) -> float | None`."""
