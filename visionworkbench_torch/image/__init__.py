"""Image substrate of the port (the parts the correlator and the refiners
use)."""
