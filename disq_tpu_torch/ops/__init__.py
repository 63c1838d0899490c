"""Device kernels (csrc/) with their wrappers and plain versions."""
