"""Ray-time operations: RNG, intersection, and the kernel wrappers."""
