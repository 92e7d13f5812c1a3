"""Acceleration structures (counterpart of prosper_tpu/accel/)."""
