"""Core utilities of the port: exceptions and device policy."""
