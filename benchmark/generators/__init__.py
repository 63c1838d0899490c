"""Input generators of the benchmark, one module per ``generator`` name
that a configuration file gives. Each makes its files from a seed."""
