"""Context, configuration and telemetry of the port."""
