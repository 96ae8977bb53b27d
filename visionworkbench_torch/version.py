"""The port's version (``visionworkbench_tpu/version.py`` holds the JAX
package's)."""

__version__ = "0.1.0"
