"""Syntax plane: decode_sb/decode_b tree walk producing work items."""
