"""Command-line tools of the port; run them as modules, for example
`python -m cardio_dmz_tpu_torch.tools.serve_demo`."""
