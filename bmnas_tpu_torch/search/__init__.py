"""Bilevel search: the weight/arch steps, the LR schedule and the epoch loop."""
