"""Plain references of the benchmark's configurations, one module per
configuration, found by the configuration's name."""
