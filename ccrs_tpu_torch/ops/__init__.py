"""Hand-written GPU kernels and their bindings (built at first use)."""
