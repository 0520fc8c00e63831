"""Host utilities of the port: image preprocessing, metrics, profiling,
and the limits that hold each CUDA kernel to its plain version."""
