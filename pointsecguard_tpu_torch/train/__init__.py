"""Port counterpart of pointsecguard_tpu.train."""
