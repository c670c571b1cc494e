"""Per-layer metric readers: ``metrics/<metric name>.py`` defines
``read(reading) -> float | None`` over a ``yardstick.trace.TraceReading``."""
