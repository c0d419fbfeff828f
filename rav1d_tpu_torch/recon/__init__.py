"""Reconstruction orchestration: frame decode driver, sbrow batching."""
