"""Port counterpart of pointsecguard_tpu.cli."""
