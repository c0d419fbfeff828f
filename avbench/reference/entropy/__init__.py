"""Entropy plane: msac range decoder + adaptive CDF contexts."""
