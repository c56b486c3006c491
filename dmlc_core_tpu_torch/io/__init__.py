"""Native I/O binding of the port (its own build of the shared C++ core)."""
