"""File IO (counterpart of prosper_tpu/io)."""
