"""Stereo correlation of the port: the block-matching pyramid correlator."""
