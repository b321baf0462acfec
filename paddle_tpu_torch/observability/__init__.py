"""Observability: the metrics registry, the flight recorder, the decision
journal and its clock, request tracing, the SLO, perf and capacity
monitors, and output-quality comparison of two serves. Every signal is
computed on the host from values the serving engine's counted fetch
already brought back; nothing here reads the device."""
