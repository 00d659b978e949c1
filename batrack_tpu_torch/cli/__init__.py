"""Command-line entry points: `python -m batrack_tpu_torch.cli.<name>`."""
