"""Shared primitives: `reduce.indexed_sum`, the segment reduction behind
the U/V/g/S accumulations."""
