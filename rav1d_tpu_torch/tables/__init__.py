"""AV1 specification normative constant tables."""
