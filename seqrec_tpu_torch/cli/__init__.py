"""Console entry points of the port (``python -m seqrec_tpu_torch.cli.test``)."""
