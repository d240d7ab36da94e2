"""Plain PyTorch references, one a configuration kind.  They import nothing
of the port and take nothing it made: only the configuration and the
benchmark's own inputs."""
