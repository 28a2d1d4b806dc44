"""Runnable examples of the port, the counterparts of ``examples/``:
``python -m nsdp_tpu_torch.examples.quickstart`` (train, evaluate and write
meshes on a synthetic fixture) and ``python -m
nsdp_tpu_torch.examples.serve_interactive`` (an edit session's drags).  Both
run on ``cuda`` unless given ``--device cpu``."""
