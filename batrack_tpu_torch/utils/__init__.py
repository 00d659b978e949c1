"""Configuration, device and timing helpers."""
