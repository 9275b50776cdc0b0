"""Launching on the card: SM partitions (gpu-lets), the L(b, p) profile
and the serving plan."""
