"""Port counterpart of pointsecguard_tpu.utils."""
