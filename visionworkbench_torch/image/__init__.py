"""Image substrate of the port (the parts the correlator uses)."""
