"""Training: ``trainer`` (the loop), ``schedule``, ``checkpoints``; run
``python -m frankenstein_tpu_torch.train`` for the CLI."""
