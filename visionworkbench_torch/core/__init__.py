"""Core utilities of the port: exceptions, device policy and timers."""
