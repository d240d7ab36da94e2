"""One module a configuration kind: its inputs from the seed, the port's
entries that serve it, and the call into its reference."""
