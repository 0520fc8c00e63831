"""Host utilities of the port: image preprocessing, metrics, profiling."""
