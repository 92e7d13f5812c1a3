"""The port's headless application: app/cli.py (counterpart of
prosper_tpu/app)."""
