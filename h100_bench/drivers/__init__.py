"""Drivers of the traffic mixes: ``traffic/<mix>.json`` names one by its
``driver`` key, and the driver reads the rest of that file."""
