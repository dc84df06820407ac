"""The port's command-line tools (run as python -m shasta_tpu_torch.tools.<name>)."""
